"""Paged decode attention: the block-table window attention as one
hand-written CUDA kernel for Hopper (csrc/paged_attention.cu).

Replaces ``paddle_tpu/ops/paged_attention.py:paged_window_attention``,
the Pallas kernel that walks the block table page by page in VMEM. On
the card the function is bound by memory bytes: each valid K/V row is
read once per head, plus q and out, over 3.35 TB/s, at a few flops per
byte. The kernel therefore never materializes the gathered window: one
thread block per (head, sequence) walks the block table itself, stages
64-row tiles of K and V in shared memory and folds them into an f32
running softmax, stopping at the last position any query may see. The
TPU schedule knobs (``schedule``, ``heads_per_tile``) and its VMEM
budget have no counterpart here.

Two functions:

* :func:`plain_window_attention` — the exact torch transcription of the
  JAX package's ``xla_window_attention``, gather included. It is what
  the CPU runs and what the kernel is held to on the card.
* :func:`paged_window_attention` — the wrapper: the plain version for
  tensors on the CPU, the kernel for tensors on a CUDA device (or an
  error; there is no fallback on the card). ``paged_window_attention
  .launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..core.enforce import enforce
from . import _cuda

__all__ = ["paged_window_attention", "plain_window_attention"]


def _take_fill(src, idx):
    """``jnp.take(src, idx, axis=0, mode="fill", fill_value=0)``:
    indices in ``[-N, 0)`` wrap from the end (the fill only triggers
    outside ``[-N, N)``) — fully masked rows of the JAX package depend
    on that wrap."""
    n = src.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    out = src[idx.clamp(0, n - 1)]
    ok = ok.reshape(ok.shape + (1,) * (src.dim() - 1))
    return torch.where(ok, out, torch.zeros((), dtype=src.dtype,
                                            device=src.device))


def plain_window_attention(q, k_pool, v_pool, tables, cached_lens, *,
                           k_scale=None, v_scale=None):
    """Window attention over a paged KV pool, written with plain torch
    ops: gather the whole block window position-ordered, attend under
    the ``window_pos <= cached + t`` mask (``-1`` table pages masked),
    softmax in f32.

    q: ``[B, T, H, Dk]``; pools ``[nb, bs, H, D]`` (int8 codes plus
    ``[nb, bs]`` f32 scale pools when ``k_scale``/``v_scale`` are
    given); tables ``[B, mb]``; cached_lens ``[B]``. Returns
    ``[B, T, H, Dv]``."""
    B, T, H, Dk = q.shape
    nb, bs = k_pool.shape[0], k_pool.shape[1]
    Dv = v_pool.shape[-1]
    mb = tables.shape[1]
    S = mb * bs
    dev = q.device
    tables = tables.to(torch.int64)
    pos = (cached_lens.to(torch.int64)[:, None]
           + torch.arange(T, device=dev)[None, :])                # [B, T]
    gidx = (tables[:, :, None] * bs
            + torch.arange(bs, device=dev)[None, None, :]).reshape(B, S)
    keys = _take_fill(k_pool.reshape(nb * bs, H, Dk), gidx)
    vals = _take_fill(v_pool.reshape(nb * bs, H, Dv), gidx)
    if k_scale is not None:
        ks = _take_fill(k_scale.reshape(nb * bs), gidx)
        vs = _take_fill(v_scale.reshape(nb * bs), gidx)
        keys = (keys.to(torch.float32) * ks[..., None, None]).to(q.dtype)
        vals = (vals.to(torch.float32) * vs[..., None, None]).to(q.dtype)
    att = torch.einsum("bqhd,bkhd->bhqk", q, keys) / math.sqrt(Dk)
    m = ((torch.arange(S, device=dev)[None, None, :] <= pos[:, :, None])
         & (gidx >= 0)[:, None, :])
    att = torch.where(m[:, None, :, :], att,
                      torch.full((), -1e9, dtype=att.dtype, device=dev))
    w = torch.softmax(att.to(torch.float32), dim=-1).to(vals.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, vals)


# q, k_pool, v_pool, tables, cached_lens, out; B, T, H, Dk, Dv, nb, bs,
# mb; stream
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
             + [ctypes.c_void_p])
_SMEM_LIMIT = 227 * 1024  # shared memory one block may use on Hopper


def _library():
    lib = _cuda.load("paged_attention")
    if not getattr(lib, "_bound", False):
        for fn in (lib.paged_window_attention_f32,
                   lib.paged_window_attention_bf16):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.paged_window_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.paged_window_attention_smem_bytes.restype = ctypes.c_size_t
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def build() -> None:
    """Build (if needed) and load the kernel library."""
    _library()


def paged_window_attention(q, k_pool, v_pool, tables, cached_lens, *,
                           k_scale=None, v_scale=None):
    """Window attention over the paged KV pool (the contract of
    :func:`plain_window_attention`).

    CPU tensors take the plain version. CUDA tensors launch the kernel:
    q and pools float32 or bfloat16 (one type), tables and cached_lens
    int32, all contiguous on one device; anything else raises. Int8
    pools (``k_scale``/``v_scale``) raise NotImplementedError on the
    card. For rows with at least one valid key the kernel matches the
    plain version; a fully masked row (an inactive slot) comes out as
    zeros, where the plain version averages whatever the wrapped ``-1``
    indices gather — both are finite, and neither is ever read."""
    if q.device.type == "cpu":
        for t in (k_pool, v_pool, tables, cached_lens):
            enforce(t.device.type == "cpu",
                    "paged_window_attention: q is on the CPU but an input "
                    "is on %s" % t.device)
        return plain_window_attention(q, k_pool, v_pool, tables,
                                      cached_lens, k_scale=k_scale,
                                      v_scale=v_scale)
    enforce(q.device.type == "cuda",
            "paged_window_attention: unsupported device %s" % q.device)
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "paged_window_attention: int8 KV pools (dequantize-on-gather) "
            "are not ported to the CUDA kernel yet")
    B, T, H, Dk = q.shape
    enforce(k_pool.dim() == 4 and v_pool.dim() == 4,
            "paged_window_attention: pools must be [nb, bs, H, D]")
    nb, bs = int(k_pool.shape[0]), int(k_pool.shape[1])
    Dv = int(v_pool.shape[-1])
    enforce(tuple(k_pool.shape) == (nb, bs, H, Dk)
            and tuple(v_pool.shape[:3]) == (nb, bs, H),
            "paged_window_attention: pool shapes %s / %s do not match q %s"
            % (tuple(k_pool.shape), tuple(v_pool.shape), tuple(q.shape)))
    enforce(tables.dim() == 2 and tables.shape[0] == B
            and tuple(cached_lens.shape) == (B,),
            "paged_window_attention: tables must be [B, mb] and "
            "cached_lens [B] for B=%d" % B)
    mb = int(tables.shape[1])
    enforce(q.dtype in (torch.float32, torch.bfloat16),
            "paged_window_attention: q must be float32 or bfloat16, got %s"
            % q.dtype)
    enforce(k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
            "paged_window_attention: pools must have q's dtype %s" % q.dtype)
    enforce(tables.dtype == torch.int32 and cached_lens.dtype == torch.int32,
            "paged_window_attention: tables and cached_lens must be int32")
    for t in (k_pool, v_pool, tables, cached_lens):
        enforce(t.device == q.device,
                "paged_window_attention: inputs on %s and %s"
                % (q.device, t.device))
    for t in (q, k_pool, v_pool, tables, cached_lens):
        enforce(t.is_contiguous(),
                "paged_window_attention: inputs must be contiguous")
    enforce(nb * bs * H * max(Dk, Dv) < 2 ** 31 and B <= 65535,
            "paged_window_attention: pool or batch too large for the "
            "kernel's 32-bit slot indexing")
    lib = _library()
    smem = lib.paged_window_attention_smem_bytes(T, Dk, Dv)
    enforce(smem <= _SMEM_LIMIT,
            "paged_window_attention: T=%d, Dk=%d, Dv=%d need %d bytes of "
            "shared memory (limit %d)" % (T, Dk, Dv, smem, _SMEM_LIMIT))
    out = torch.empty((B, T, H, Dv), dtype=q.dtype, device=q.device)
    fn = (lib.paged_window_attention_f32 if q.dtype == torch.float32
          else lib.paged_window_attention_bf16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 tables.data_ptr(), cached_lens.data_ptr(), out.data_ptr(),
                 B, T, H, Dk, Dv, nb, bs, mb, stream)
    if err != 0:
        raise RuntimeError("paged_window_attention: kernel launch failed: "
                           "CUDA error %d (%s)" % (
                               err, lib.paged_attention_error_string(
                                   err).decode()))
    paged_window_attention.launches += 1
    return out


paged_window_attention.launches = 0
