"""Flash attention, forward and backward, as three hand-written CUDA
kernels for Hopper (csrc/flash_attention.cu).

Replaces the Pallas family of ``paddle_tpu/ops/flash_attention.py``:
``_mha_forward`` (kernel ``_fwd_kernel``), and the two kernels of
``_mha_backward`` (``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``), tied
together by ``jax.custom_vjp``. Here each kernel is a
``torch.library`` custom op (``paddle_tpu_torch::flash_fwd``,
``::flash_bwd_dq``, ``::flash_bwd_dkv``), and the forward op's
registered autograd formula ties them: it saves ``(q, k, v, mask, o,
lse)`` and its backward calls the dQ op, then the dK/dV op.

What the kernels compute, and what they keep out of device memory, is
the TPU family's: the ``[Tq, Tk]`` scores never reach device memory;
the forward keeps a running max, sum and accumulator per query row and
writes ``o`` and the per-row logsumexp; the backward rebuilds the
probabilities from that logsumexp. The TPU grid, its block caps, the
head-major transposes and the padding of ragged lengths to block
multiples were for the TPU's tiling and are not carried over: the
kernels read the public ``[B, T, H, D]`` layout through strides and
mask the ragged edge themselves. The dQ kernel also writes
``delta = rowsum(dO * O)``, which the dK/dV kernel reads (the JAX
package computes it with an XLA op before both kernels).

Semantics (shared by the kernels and the plain versions): scores
``q . k * scale``; a key with ``kv_mask <= 0`` and, under ``causal``, a
key past the query's position (``k_pos > q_pos``, top-left aligned) get
``-inf``; a row with no valid key writes ``o = 0`` and
``lse = +inf``, so its backward probabilities are 0 — as the Pallas
kernels do.

Functions:

* :func:`flash_attention` — the public op, the JAX signature and
  layout: ``q [B, Tq, H, D]``, ``k, v [B, Tk, H, D]``, ``kv_mask
  [B, Tk]``. Differentiable.
* :func:`plain_flash_forward` / :func:`plain_flash_backward` — the
  kernels' math written with plain torch ops; what CPU tensors run and
  what the kernels are held to on the card.
  :func:`plain_flash_forward_bf16` and :func:`plain_flash_backward_bf16`
  add the bf16 kernels' rounding (the forward's p as two bf16 parts
  before P V, tile by tile; the backward's p and ds to bf16 before the
  second products); the card tests hold those kernels to them element
  by element (:func:`bf16_ulps` at most 1).
* :func:`flash_fwd`, :func:`flash_bwd_dq`, :func:`flash_bwd_dkv` — the
  three ops. The dispatcher picks the kernel by device: a CPU tensor
  takes the plain version, a meta or fake one (build-time shape
  inference, tracing) the fake kernel, a CUDA tensor the hand-written
  kernel, which raises on what it does not take (float32 or bfloat16,
  head dim 64 or 128; inputs whose pointer or (batch, time, head)
  strides are not 16-byte aligned are refused too). Each has a
  ``.launches`` counter of kernel launches, raised by the CUDA kernel
  alone.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core.enforce import enforce
from . import _cuda

__all__ = ["BF16_MODEL_FLOOR", "bf16_ulps", "flash_attention",
           "flash_bwd_dkv", "flash_bwd_dq", "flash_fwd",
           "plain_flash_backward", "plain_flash_backward_bf16",
           "plain_flash_forward", "plain_flash_forward_bf16"]

HEAD_DIMS = (64, 128)  # head dims the kernels are instantiated for
# the tile the library is built with (csrc/flash_attention.cu kTile: 64
# query rows a block): the one point of the ``flash_attention`` tunable,
# which no launch looks up while there is nothing else to choose
BUILT_TILE = 64


# ---------------------------------------------------------------- plain


def _scores(q, k, causal, scale, kv_mask):
    """Masked f32 scores ``[B, H, Tq, Tk]`` and the validity mask."""
    Tq, Tk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    valid = torch.ones((1, 1, Tq, Tk), dtype=torch.bool, device=q.device)
    if kv_mask is not None:
        valid = valid & (kv_mask[:, None, None, :] > 0)
    if causal:
        valid = valid & torch.ones((Tq, Tk), dtype=torch.bool,
                                   device=q.device).tril()
    return torch.where(valid, s, -torch.inf), valid


def plain_flash_forward(q, k, v, causal=False, scale=None, kv_mask=None):
    """(o ``[B, Tq, H, D]`` in q's dtype, lse ``[B, H, Tq]`` f32): the
    forward kernel's function with plain torch ops, sums in f32."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s, valid = _scores(q, k, causal, scale, kv_mask)
    m = s.amax(-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(valid, torch.exp(s - m_safe), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o = o / l.clamp_min(1e-30).permute(0, 2, 1, 3)
    lse = torch.where(l > 0, m_safe + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, torch.inf))
    return o.to(q.dtype), lse[..., 0]


def plain_flash_forward_bf16(q, k, v, causal=False, scale=None,
                             kv_mask=None, key_tile=64, p_parts=2):
    """:func:`plain_flash_forward` with the bf16 forward kernel's
    rounding: it walks key tiles of ``key_tile`` keys with a running
    max, as the kernel does, and rounds each tile's ``p = exp(s -
    m_run)`` to bfloat16 parts (to nearest even) before P V, since the
    kernel feeds p to the tensor cores as bf16 operands: with
    ``p_parts=2`` (the kernel) as hi = bf16(p) and lo = bf16(p - hi),
    P V = hi V + lo V, so p keeps 16 significant bits; with
    ``p_parts=1`` as one bf16 value, what a kernel with a single bf16 P
    would do. The row sum l takes the unrounded p; sums, the running
    max and the rescaling stay in f32."""
    enforce(p_parts in (1, 2), "p_parts must be 1 or 2, got %r" % p_parts)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s, valid = _scores(q, k, causal, scale, kv_mask)
    B, H, Tq, Tk = s.shape
    vf = v.float()
    m = torch.full((B, H, Tq, 1), -torch.inf, device=q.device)
    l = torch.zeros((B, H, Tq, 1), device=q.device)
    acc = torch.zeros((B, H, Tq, vf.shape[-1]), device=q.device)
    for k0 in range(0, Tk, key_tile):
        st = s[..., k0:k0 + key_tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                           torch.zeros_like(m))
        p = torch.where(valid[..., k0:k0 + key_tile], torch.exp(st - m_safe),
                        torch.zeros_like(st))
        l = l * corr + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        if p_parts == 2:  # hi + lo is exact in f32
            hi = hi + (p - hi).to(torch.bfloat16).float()
        acc = acc * corr + torch.einsum("bhqk,bkhd->bhqd", hi,
                                        vf[:, k0:k0 + key_tile])
        m = m_new
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    o = (acc / l.clamp_min(1e-30)).permute(0, 2, 1, 3)
    lse = torch.where(l > 0, m_safe + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, torch.inf))
    return o.to(q.dtype), lse[..., 0]


def _delta(o, do):
    """``rowsum(dO * O)`` ``[B, H, Tq]`` f32."""
    return (do.float() * o.float()).sum(-1).permute(0, 2, 1)


def _probs(q, k, v, lse, delta, do, causal, scale, kv_mask):
    """The backward's f32 probabilities ``p`` and score gradients
    ``ds`` ``[B, H, Tq, Tk]``, rebuilt from ``lse`` and ``delta``."""
    s, valid = _scores(q, k, causal, scale, kv_mask)
    p = torch.where(valid, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def _backward(q, k, v, o, lse, do, causal, scale, kv_mask, operand):
    """(dq, dk, dv); ``operand`` is the dtype p and ds are rounded to
    before the second products (None: kept in f32)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    p, ds = _probs(q, k, v, lse, _delta(o, do), do, causal, scale, kv_mask)
    if operand is not None:
        p, ds = p.to(operand).float(), ds.to(operand).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def plain_flash_backward(q, k, v, o, lse, do, causal=False, scale=None,
                         kv_mask=None):
    """(dq, dk, dv) in their inputs' dtypes: the two backward kernels'
    function with plain torch ops. The probabilities are rebuilt from
    ``lse`` ``[B, H, Tq]``; ``delta = rowsum(dO * O)``."""
    return _backward(q, k, v, o, lse, do, causal, scale, kv_mask, None)


def plain_flash_backward_bf16(q, k, v, o, lse, do, causal=False,
                              scale=None, kv_mask=None):
    """:func:`plain_flash_backward` with the bf16 kernels' one extra
    rounding: p and ds, computed in f32, are rounded to bfloat16 (to
    nearest even) before they enter the second products (dq = ds k,
    dk = ds^T q, dv = p^T dO), since the kernels feed them to the
    tensor cores as bf16 operands. Sums stay in f32."""
    return _backward(q, k, v, o, lse, do, causal, scale, kv_mask,
                     torch.bfloat16)


# How far the bf16 backward kernels may sit from
# plain_flash_backward_bf16, element by element: one bf16 ulp of the
# element (both round f32 sums taken in another order) plus this share
# of max |grad| (f32 order and exp2 against exp flip the bf16 rounding of
# a few p and ds, which can move a near-cancelling element by more than
# its own ulp).
BF16_MODEL_FLOOR = 1e-3


def bf16_ulps(got, want) -> float:
    """max over elements of |got - want| / (one bf16 ulp of want +
    BF16_MODEL_FLOOR * max |want|): at most 1 when every element is that
    close."""
    w = want.float()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - 8)  # 8 significant bits
    slack = BF16_MODEL_FLOOR * float(w.abs().max())
    return float(((got.float() - w).abs() / (ulp + slack)).max())


# ---------------------------------------------------------------- kernels

# q, k, v, mask, o, lse; B, H, Tq, Tk, D; strides (b, t, h) of q, k, v;
# mask batch stride; causal; scale; stream
_FWD_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 10 + [ctypes.c_int, ctypes.c_float,
                                           ctypes.c_void_p])
# q, k, v, do, o, mask, lse, delta, dq; B, H, Tq, Tk, D; strides of q, k,
# v, do, o; mask batch stride; causal; scale; stream
_DQ_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 16 + [ctypes.c_int, ctypes.c_float,
                                          ctypes.c_void_p])
# q, k, v, do, mask, lse, delta, dk, dv; B, H, Tq, Tk, D; strides of q,
# k, v, do; mask batch stride; causal; scale; stream
_DKV_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 13 + [ctypes.c_int, ctypes.c_float,
                                           ctypes.c_void_p])
_SMEM_LIMIT = 227 * 1024  # shared memory one block may use on Hopper


def _bind(lib):
    """Set the ctypes signatures of a built kernel library's entry
    points (profile_flash.py binds its probe build the same way)."""
    for name, argtypes in (("flash_fwd", _FWD_ARGS),
                           ("flash_bwd_dq", _DQ_ARGS),
                           ("flash_bwd_dkv", _DKV_ARGS)):
        for suffix in ("f32", "bf16"):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.flash_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.flash_smem_bytes.restype = ctypes.c_size_t
    if hasattr(lib, "flash_blocks_per_sm"):  # another version may lack it
        lib.flash_blocks_per_sm.argtypes = [ctypes.c_int] * 3
        lib.flash_blocks_per_sm.restype = ctypes.c_int
    lib.flash_error_string.argtypes = [ctypes.c_int]
    lib.flash_error_string.restype = ctypes.c_char_p
    lib._bound = True


def _library():
    lib = _cuda.load("flash_attention")
    if not getattr(lib, "_bound", False):
        _bind(lib)
    return lib


def build() -> None:
    """Build (if needed) and load the kernel library."""
    _library()


def _strides(t):
    return [int(s) for s in t.stride()[:3]]


def _check_cuda(name, q, k, v, kv_mask, *more):
    """Refuse what the kernels do not take; returns (B, Tq, Tk, H, D)."""
    enforce(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
            "%s: q, k, v must be [B, T, H, D]" % name)
    B, Tq, H, D = (int(s) for s in q.shape)
    Tk = int(k.shape[1])
    enforce(tuple(k.shape) == (B, Tk, H, D) and tuple(v.shape) == (B, Tk, H, D),
            "%s: k %s and v %s do not match q %s"
            % (name, tuple(k.shape), tuple(v.shape), tuple(q.shape)))
    enforce(D in HEAD_DIMS,
            "%s: head dim %d has no kernel (the kernels are built for %s)"
            % (name, D, HEAD_DIMS))
    enforce(q.dtype in (torch.float32, torch.bfloat16),
            "%s: q must be float32 or bfloat16, got %s" % (name, q.dtype))
    for t in (k, v) + more:
        enforce(t.dtype == q.dtype,
                "%s: inputs must share q's dtype %s, got %s"
                % (name, q.dtype, t.dtype))
    for t in (k, v) + more:
        enforce(t.device == q.device,
                "%s: inputs on %s and %s" % (name, q.device, t.device))
        enforce(t.stride(-1) == 1,
                "%s: the head dim must be contiguous" % name)
    enforce(q.stride(-1) == 1, "%s: the head dim must be contiguous" % name)
    if kv_mask is not None:
        enforce(tuple(kv_mask.shape) == (B, Tk)
                and kv_mask.dtype == torch.float32
                and kv_mask.device == q.device and kv_mask.stride(-1) == 1,
                "%s: kv_mask must be float32 [B, Tk] = [%d, %d] on %s"
                % (name, B, Tk, q.device))
    enforce(B * H <= 2 ** 31 - 1 and (Tq + 63) // 64 <= 65535
            and (Tk + 63) // 64 <= 65535,
            "%s: shape too large for the launch grid" % name)
    return B, Tq, Tk, H, D


def _check_launch(name, lib, err):
    if err != 0:
        raise RuntimeError("%s: kernel launch failed: CUDA error %d (%s)"
                           % (name, err,
                              lib.flash_error_string(err).decode()))


def _smem_ok(name, lib, kind, D, dtype):
    smem = lib.flash_smem_bytes(kind, D, int(dtype == torch.bfloat16))
    enforce(smem <= _SMEM_LIMIT,
            "%s: D=%d needs %d bytes of shared memory (limit %d)"
            % (name, D, smem, _SMEM_LIMIT))


def _check_aligned(name, *tensors):
    """The kernels copy rows with 16-byte cp.async: every
    pointer and every (batch, time, head) stride must be a multiple of
    16 bytes (a stride of a size-1 dim is never used). Refused, never
    copied: the models pass reshapes of contiguous ``fc`` outputs,
    which are aligned."""
    for t in tensors:
        item = t.element_size()
        enforce(t.data_ptr() % 16 == 0
                and all(s * item % 16 == 0 for s, n in
                        zip(t.stride()[:3], t.shape[:3]) if n > 1),
                "%s: inputs must be 16-byte aligned (pointer and the "
                "batch, time and head strides); got a %s tensor at "
                "pointer %% 16 = %d with strides %s"
                % (name, t.dtype, t.data_ptr() % 16, tuple(t.stride())))


def _mask_arg(kv_mask):
    if kv_mask is None:
        return None, 0
    return kv_mask.data_ptr(), int(kv_mask.stride(0))


def _fn(lib, name, dtype):
    return getattr(lib, name + ("_f32" if dtype == torch.float32
                                else "_bf16"))


def _scale(q, scale) -> float:
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


def _contiguous(*ts):
    return tuple(t.contiguous() for t in ts)


# ---------------------------------------------------------------- ops
#
# Each kernel is a torch.library custom op: a graph that torch.export
# writes names the op, and the dispatcher picks its kernel by the device
# of the tensors when the graph runs. The CPU kernel is the plain
# version, the CUDA kernel the hand-written one (or it raises), and the
# fake kernel gives tracing (and build-time shape inference on "meta"
# tensors) the shapes and dtypes. The launch counters rise in the CUDA
# kernels only, so a trace counts nothing.


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=(),
                         device_types="cpu")
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_mask: Optional[torch.Tensor], causal: bool,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return _contiguous(*plain_flash_forward(q, k, v, causal, scale,
                                            kv_mask))


@_flash_fwd_op.register_fake
def _(q, k, v, kv_mask, causal, scale):
    B, Tq, H = q.shape[:3]
    return (q.new_empty((B, Tq, H, v.shape[-1])),
            q.new_empty((B, H, Tq), dtype=torch.float32))


@_flash_fwd_op.register_kernel("cuda")
def _flash_fwd_cuda(q, k, v, kv_mask, causal, scale):
    B, Tq, Tk, H, D = _check_cuda("flash_fwd", q, k, v, kv_mask)
    _check_aligned("flash_fwd", q, k, v)
    lib = _library()
    _smem_ok("flash_fwd", lib, 0, D, q.dtype)
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    mask_ptr, mask_sb = _mask_arg(kv_mask)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn(lib, "flash_fwd", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr,
            o.data_ptr(), lse.data_ptr(), B, H, Tq, Tk, D,
            *_strides(q), *_strides(k), *_strides(v), mask_sb,
            int(causal), scale, stream)
    _check_launch("flash_fwd", lib, err)
    flash_fwd.launches += 1
    return o, lse


@torch.library.custom_op("paddle_tpu_torch::flash_bwd_dq", mutates_args=(),
                         device_types="cpu")
def _flash_bwd_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                     kv_mask: Optional[torch.Tensor], causal: bool,
                     scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    delta = _delta(o, do)
    _, ds = _probs(q, k, v, lse, delta, do, causal, scale, kv_mask)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)
    return _contiguous(dq, delta)


@_flash_bwd_dq_op.register_fake
def _(q, k, v, o, lse, do, kv_mask, causal, scale):
    return torch.empty_like(q), torch.empty_like(lse)


@_flash_bwd_dq_op.register_kernel("cuda")
def _(q, k, v, o, lse, do, kv_mask, causal, scale):
    B, Tq, Tk, H, D = _check_cuda("flash_bwd_dq", q, k, v, kv_mask, o, do)
    enforce(tuple(lse.shape) == (B, H, Tq) and lse.dtype == torch.float32
            and lse.is_contiguous() and lse.device == q.device,
            "flash_bwd_dq: lse must be contiguous float32 [B, H, Tq]")
    _check_aligned("flash_bwd_dq", q, k, v, o, do)
    lib = _library()
    _smem_ok("flash_bwd_dq", lib, 1, D, q.dtype)
    dq = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    mask_ptr, mask_sb = _mask_arg(kv_mask)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn(lib, "flash_bwd_dq", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            o.data_ptr(), mask_ptr, lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), B, H, Tq, Tk, D,
            *_strides(q), *_strides(k), *_strides(v), *_strides(do),
            *_strides(o), mask_sb, int(causal), scale, stream)
    _check_launch("flash_bwd_dq", lib, err)
    flash_bwd_dq.launches += 1
    return dq, delta


@torch.library.custom_op("paddle_tpu_torch::flash_bwd_dkv",
                         mutates_args=(), device_types="cpu")
def _flash_bwd_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lse: torch.Tensor, delta: torch.Tensor,
                      do: torch.Tensor, kv_mask: Optional[torch.Tensor],
                      causal: bool, scale: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    p, ds = _probs(q, k, v, lse, delta, do, causal, scale, kv_mask)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).to(k.dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float()).to(v.dtype)
    return _contiguous(dk, dv)


@_flash_bwd_dkv_op.register_fake
def _(q, k, v, lse, delta, do, kv_mask, causal, scale):
    return torch.empty_like(k), torch.empty_like(v)


@_flash_bwd_dkv_op.register_kernel("cuda")
def _(q, k, v, lse, delta, do, kv_mask, causal, scale):
    B, Tq, Tk, H, D = _check_cuda("flash_bwd_dkv", q, k, v, kv_mask, do)
    for name, t in (("lse", lse), ("delta", delta)):
        enforce(tuple(t.shape) == (B, H, Tq) and t.dtype == torch.float32
                and t.is_contiguous() and t.device == q.device,
                "flash_bwd_dkv: %s must be contiguous float32 [B, H, Tq]"
                % name)
    _check_aligned("flash_bwd_dkv", q, k, v, do)
    lib = _library()
    _smem_ok("flash_bwd_dkv", lib, 2, D, q.dtype)
    dk = torch.empty((B, Tk, H, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Tk, H, D), dtype=v.dtype, device=q.device)
    mask_ptr, mask_sb = _mask_arg(kv_mask)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn(lib, "flash_bwd_dkv", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            mask_ptr, lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, H, Tq, Tk, D,
            *_strides(q), *_strides(k), *_strides(v), *_strides(do),
            mask_sb, int(causal), scale, stream)
    _check_launch("flash_bwd_dkv", lib, err)
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_fwd(q, k, v, causal=False, scale=None, kv_mask=None):
    """(o, lse): the ``flash_fwd`` op — the forward kernel on a CUDA
    tensor, the plain version on a CPU one."""
    return _flash_fwd_op(q, k, v, kv_mask, bool(causal), _scale(q, scale))


def flash_bwd_dq(q, k, v, o, lse, do, causal=False, scale=None,
                 kv_mask=None):
    """(dq, delta): the ``flash_bwd_dq`` op — on a CUDA tensor the dQ
    kernel, which also writes ``delta = rowsum(dO * O)`` ``[B, H, Tq]``
    f32 for the dK/dV kernel; on a CPU one the same two with plain
    torch ops."""
    return _flash_bwd_dq_op(q, k, v, o, lse, do, kv_mask, bool(causal),
                            _scale(q, scale))


def flash_bwd_dkv(q, k, v, lse, delta, do, causal=False, scale=None,
                  kv_mask=None):
    """(dk, dv): the ``flash_bwd_dkv`` op — the dK/dV kernel on a CUDA
    tensor, reading the ``delta`` that :func:`flash_bwd_dq` wrote; the
    plain version on a CPU one."""
    return _flash_bwd_dkv_op(q, k, v, lse, delta, do, kv_mask,
                             bool(causal), _scale(q, scale))


for _launcher in (flash_fwd, flash_bwd_dq, flash_bwd_dkv):
    _cuda.register_launcher(_launcher)


def flash_backward(q, k, v, o, lse, do, causal=False, scale=None,
                   kv_mask=None):
    """(dq, dk, dv): the dQ op, then the dK/dV op on the same stream."""
    dq, delta = flash_bwd_dq(q, k, v, o, lse, do, causal, scale, kv_mask)
    dk, dv = flash_bwd_dkv(q, k, v, lse, delta, do, causal, scale, kv_mask)
    return dq, dk, dv


def _fwd_setup(ctx, inputs, output):
    q, k, v, kv_mask, causal, scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, kv_mask, o, lse)
    ctx.causal, ctx.scale = causal, scale
    ctx.mark_non_differentiable(lse)


def _fwd_backward(ctx, do, _dlse):
    q, k, v, kv_mask, o, lse = ctx.saved_tensors
    if do.stride(-1) != 1:
        do = do.contiguous()
    dq, dk, dv = flash_backward(q, k, v, o, lse, do, ctx.causal, ctx.scale,
                                kv_mask)
    return dq, dk, dv, None, None, None


_flash_fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup)


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, kv_mask=None):
    """Multi-head attention, differentiable: ``q [B, Tq, H, D]``, ``k, v
    [B, Tk, H, D]``, ``kv_mask`` an optional ``[B, Tk]`` 0/1 mask over
    keys. The ``flash_fwd`` op, whose backward is the ``flash_bwd_dq``
    and ``flash_bwd_dkv`` ops: CPU tensors run the plain versions, CUDA
    tensors the kernels (or raise)."""
    for t in (k, v) + (() if kv_mask is None else (kv_mask,)):
        enforce(t.device == q.device,
                "flash_attention: q is on %s but an input is on %s"
                % (q.device, t.device))
    if kv_mask is not None:
        kv_mask = kv_mask.to(torch.float32)
        if kv_mask.stride(-1) != 1:
            kv_mask = kv_mask.contiguous()
    return _flash_fwd_op(q, k, v, kv_mask, bool(causal), _scale(q, scale))[0]
