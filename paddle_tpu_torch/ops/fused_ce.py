"""Fused linear + softmax-cross-entropy over vocab chunks (counterpart
of paddle_tpu/ops/fused_ce.py).

``loss = CE(x @ W + b, labels)`` without any ``[N, V]`` tensor in
device memory, in either direction:

* forward: a loop over vocab chunks with online (max, sum-exp)
  accumulators in f32; each chunk's ``[N, Cv]`` logits live only in its
  iteration. Saved for backward: the f32 row log-sum-exp (and the
  inputs).
* backward: each chunk's logits are computed again from ``(x, W)``, its
  cotangent ``(softmax - target) * dloss`` formed and fed at once to
  both gradient matmuls (``dW``'s columns written in place, ``dx``
  accumulated in f32).

The JAX package's op is a ``jax.custom_vjp`` around two ``lax.scan``s,
not a Pallas kernel; here it is a ``torch.autograd.Function`` around two
Python loops, the chunk products on cuBLAS (``torch.mm``, and
``layers.nn._mm_f32`` for bf16 operands with an f32 result).

Chunking (:func:`_chunking`) is the JAX package's: an exact divisor of
V near the cap when there is one (V = 32000: 8 chunks of 4000), else a
fixed chunk count with 128-aligned chunks and a zero-padded tail whose
columns are ``-inf`` in every reduction. ``chunk_cap`` defaults to
``DEFAULT_CHUNK_CAP``: the port has no tuning tables yet.

Precision follows the JAX package's rule, read when the layer is built:
under ``use_bfloat16`` the chunk logits are products of bf16 operands
with f32 results, and the cotangent is cast to bf16 before both
gradient matmuls; otherwise the products run in x's dtype with f32
results. Label smoothing folds in as the JAX package's
``softmax_with_cross_entropy`` does: ``(1 - eps) * onehot + eps / V``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..layers.nn import _mm_f32

__all__ = ["DEFAULT_CHUNK_CAP", "fused_linear_softmax_ce_fn"]

DEFAULT_CHUNK_CAP = 4096


def _chunk_size(V: int, cap: int = 4096) -> int:
    """Largest divisor of V that is <= cap (1 when none is useful)."""
    best = 1
    for c in range(1, int(np.sqrt(V)) + 1):
        if V % c == 0:
            for d in (c, V // c):
                if d <= cap:
                    best = max(best, d)
    return best


def _chunking(V: int, cap: int = 4096):
    """(Cv, K, Vp): chunk size, chunk count, padded vocab (K * Cv). An
    exact divisor of V when one of at least cap/2 exists (no padding);
    else the chunk count is fixed first and the chunks sized to fit V,
    rounded up to a multiple of 128, so the pad stays under K * 128
    columns."""
    best = _chunk_size(V, cap)
    if best >= cap // 2:
        return best, V // best, V
    K = max(1, -(-V // cap))
    if K == 1:
        return V, 1, V
    per_k = -(-V // K)
    Cv = -(-per_k // 128) * 128
    K = -(-V // Cv)
    return Cv, K, K * Cv


def _mm32(a, b):
    """f32 product of two matrices of one dtype."""
    return torch.mm(a, b) if a.dtype == torch.float32 else _mm_f32(a, b)


def _logits(x, W_c, b_c, col0, V, bf16):
    """One chunk's f32 logits ``[N, Cv]``, pad columns (at or past V)
    set to ``-inf``."""
    dt = torch.bfloat16 if bf16 else x.dtype
    lg = _mm32(x.to(dt), W_c.to(dt))
    if b_c is not None:
        lg = lg + b_c.to(torch.float32)
    Cv = W_c.shape[1]
    if col0 + Cv > V:
        valid = torch.arange(col0, col0 + Cv, device=lg.device) < V
        lg = torch.where(valid[None, :], lg,
                         torch.full((), -torch.inf, dtype=lg.dtype,
                                    device=lg.device))
    return lg


def _padded(W, b, V, Vp):
    """W and b zero-padded on the vocab axis to Vp (themselves when
    Vp == V)."""
    if Vp == V:
        return W, b
    Wp = torch.nn.functional.pad(W, (0, Vp - V))
    bp = torch.nn.functional.pad(b, (0, Vp - V)) if b is not None else None
    return Wp, bp


class _FusedLinearCE(torch.autograd.Function):
    """``loss [N] f32`` of ``x [N, d]``, ``W [d, V]``, ``b [V]`` or
    None, ``idx [N]`` int64; see the module docstring."""

    @staticmethod
    def forward(ctx, x, W, b, idx, eps, bf16, chunk_cap):
        N = x.shape[0]
        V = W.shape[1]
        Cv, K, Vp = _chunking(V, chunk_cap)
        Wp, bp = _padded(W, b, V, Vp)
        f32 = dict(dtype=torch.float32, device=x.device)
        m = torch.full((N,), -torch.inf, **f32)
        s = torch.zeros((N,), **f32)
        picked = torch.zeros((N,), **f32)
        sum_lg = torch.zeros((N,), **f32) if eps else None
        for c in range(K):
            col0 = c * Cv
            lg = _logits(x, Wp[:, col0:col0 + Cv],
                         bp[col0:col0 + Cv] if bp is not None else None,
                         col0, V, bf16)
            m_new = torch.maximum(m, lg.amax(1))
            s = s * torch.exp(m - m_new) + torch.exp(
                lg - m_new[:, None]).sum(1)
            m = m_new
            local = idx - col0
            inside = (local >= 0) & (local < Cv)
            got = torch.gather(lg, 1, local.clamp(0, Cv - 1)[:, None])[:, 0]
            picked = picked + torch.where(inside, got,
                                          torch.zeros((), **f32))
            if eps:
                sum_lg = sum_lg + torch.where(torch.isfinite(lg), lg,
                                              torch.zeros((), **f32)).sum(1)
        lse = m + torch.log(s)
        if eps:
            loss = lse - (1.0 - eps) * picked - eps * (sum_lg / V)
        else:
            loss = lse - picked
        ctx.save_for_backward(x, W, b if b is not None else x.new_empty(0),
                              idx, lse)
        ctx.has_bias, ctx.eps, ctx.bf16, ctx.cap = (b is not None, eps,
                                                    bf16, chunk_cap)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        x, W, b, idx, lse = ctx.saved_tensors
        b = b if ctx.has_bias else None
        eps, bf16 = ctx.eps, ctx.bf16
        N, d = x.shape
        V = W.shape[1]
        Cv, K, Vp = _chunking(V, ctx.cap)
        Wp, bp = _padded(W, b, V, Vp)
        dloss = dloss.to(torch.float32)
        gdt = torch.bfloat16 if bf16 else x.dtype
        xg = x.to(gdt)
        f32 = dict(dtype=torch.float32, device=x.device)
        dx = torch.zeros((N, d), **f32)
        dW = torch.empty((d, Vp), dtype=W.dtype, device=W.device)
        db = (torch.empty((Vp,), dtype=b.dtype, device=b.device)
              if b is not None else None)
        tgt_at = torch.full((), 1.0 - eps, **f32)
        if eps:
            tgt_at = tgt_at + eps / V
        for c in range(K):
            col0 = c * Cv
            W_c = Wp[:, col0:col0 + Cv]
            lg = _logits(x, W_c, bp[col0:col0 + Cv] if bp is not None
                         else None, col0, V, bf16)
            g = torch.exp(lg - lse[:, None])  # pad columns: exp(-inf) = 0
            local = idx - col0
            inside = (local >= 0) & (local < Cv)
            at = local.clamp(0, Cv - 1)[:, None]
            p_at = torch.gather(g, 1, at)
            if eps:
                g.sub_(eps / V)
            # (p - tgt) at the label, in the JAX package's rounding; a
            # row whose label lies in another chunk keeps its value
            g.scatter_(1, at, torch.where(inside[:, None], p_at - tgt_at,
                                          torch.gather(g, 1, at)))
            dlg = (g * dloss[:, None]).to(gdt)
            # pad columns of dlg are -eps/V * dloss under smoothing: they
            # meet Wp's zero pad columns in dx, and are cut from dW, db
            dW[:, col0:col0 + Cv] = _mm32(xg.t(), dlg).to(W.dtype)
            dx += _mm32(dlg, W_c.to(gdt).t())
            if db is not None:
                db[col0:col0 + Cv] = dlg.to(torch.float32).sum(0).to(
                    db.dtype)
        if Vp != V:
            dW = dW[:, :V].contiguous()
            db = db[:V].contiguous() if db is not None else None
        return dx.to(x.dtype), dW, db, None, None, None, None


def fused_linear_softmax_ce_fn(x, W, b, labels, smooth_eps: float = 0.0,
                               chunk_cap: Optional[int] = None,
                               bf16: bool = False):
    """x ``[..., d]``, W ``[d, V]``, b ``[V]`` or None, labels ``[...]``
    or ``[..., 1]`` integer -> loss ``[..., 1]`` f32. ``bf16`` is the
    ``use_bfloat16`` rule (the caller reads the flag when it builds);
    ``chunk_cap`` bounds the chunk width (default
    ``DEFAULT_CHUNK_CAP``)."""
    eps = float(smooth_eps or 0.0)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    idx = labels.to(torch.int64)
    if idx.dim() and idx.shape[-1] == 1 and idx.dim() == x.dim():
        idx = idx.squeeze(-1)
    cap = int(chunk_cap if chunk_cap is not None else DEFAULT_CHUNK_CAP)
    loss = _FusedLinearCE.apply(x2, W, b, idx.reshape(-1), eps, bool(bf16),
                                cap)
    return loss.reshape(*lead, 1)
