"""Training dropout's mask, drawn and applied by a hand-written CUDA
kernel for Hopper (csrc/dropout.cu).

Computes the training branch of the JAX package's dropout op
(``paddle_tpu/layers/nn.py``, dropout's fn)::

    key  = fold_in(PRNGKey(base_seed), uint32(counter))
    mask = bernoulli(key, 1 - p, x.shape)   # uniform_f32 < f32(1 - p)
    out  = x * mask.astype(x.dtype)

bit for bit, with ``jax.random``'s threefry on its partitionable path.
No Pallas kernel stands behind it (XLA fuses ``jax.random.bernoulli``
into the surrounding work); in plain torch the threefry is ~170 int64
elementwise ops an element, pathological at a training step's millions
of draws, so the mask is drawn by a kernel that keeps the words in
registers.

Functions:

* :func:`plain_dropout` — the same function with plain torch ops
  (``core/prng.py``). What CPU tensors run and what the kernel is held
  to on the card.
* :func:`dropout_apply` — the ``paddle_tpu_torch::dropout_apply``
  custom op: ``x * mask`` on a CUDA tensor in one kernel launch (or
  raises), the plain version on a CPU tensor. The
  counter is a one-element int32 tensor on ``x``'s device, read by the
  kernel (no host read); ``counter_out``, when given, receives
  ``counter + 1`` from the same launch. It counts its launches in
  ``.launches`` and, of those, the backward pass's in
  ``.backward_launches``.
* :func:`dropout` — the layer's op: ``(x * mask, counter + 1)`` as a
  ``torch.autograd.Function`` over ``dropout_apply`` whose backward is
  ``dropout_apply`` on the incoming gradient under the counter its
  forward read (the mask drawn again, none stored).
* :func:`dropout_apply_keyed` / :func:`dropout_keyed` — the same mask
  under a key the caller derived itself (``core/prng.fold_in`` chains
  on the card: the pipelined encoder's per-microbatch, per-layer,
  per-site keys), given as its two words in a device tensor; the
  launch reads them there. ``dropout_apply.keyed_launches`` counts these
  launches beside ``.launches``. The plain version is
  ``x * core.prng.bernoulli(key, 1 - p, x.shape)``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ..core import prng
from ..core.enforce import enforce
from . import _cuda

__all__ = ["dropout", "dropout_apply", "dropout_apply_keyed",
           "dropout_keyed", "keep_threshold", "key_words", "plain_dropout",
           "plain_dropout_keyed"]

_DTYPES = (torch.float32, torch.bfloat16)
# integer operations the kernel spends on one element: the threefry's 20
# rounds (add, rotate, xor) and 5 key injections of 2 adds, its 2 input
# adds, and the xor, shift and or that form the uniform's bits
INT_OPS_PER_ELEMENT = 20 * 3 + 5 * 2 + 2 + 3
# integer or logic operations one Hopper SM can issue a clock: 4
# schedulers, each one 32-lane warp instruction a clock. The INT32 ALUs
# alone take 64 a clock, but nvcc also issues integer adds as IMAD/IADD3
# on the FMA pipe, and the kernel runs faster than 64 a clock would
# allow, so only the issue rate bounds it.
INT_LANES_PER_SM = 128


def keep_threshold(p: float) -> float:
    """``f32(1 - p)``: the probability ``jax.random.bernoulli`` keeps an
    element with (1 - p rounded in Python's double, then to f32)."""
    return float(np.float32(1.0 - float(p)))


def plain_dropout(x: torch.Tensor, seed: int, counter: torch.Tensor,
                  p: float, offset: int = 0) -> torch.Tensor:
    """``x * bernoulli(fold_in(PRNGKey(seed), counter), 1 - p)`` with
    plain torch ops; ``counter`` is a one-element integer tensor.
    ``offset``: ``x`` is the elements from that flat index on of a
    larger tensor, and takes its block of that tensor's mask."""
    key = prng.fold_in(prng.prng_key(torch.tensor(int(seed),
                                                  device=counter.device)),
                       counter.reshape(()))
    mask = prng.bernoulli(key, keep_threshold(p), x.shape, offset=offset)
    return x * mask.to(x.dtype)


def key_words(key) -> torch.Tensor:
    """A ``core.prng`` key (two uint32 words held in int64 tensors) as
    the kernel takes it: one int32 tensor of the two words' bits."""
    k1, k2 = key
    words = torch.stack([k1.reshape(()), k2.reshape(())]) & 0xFFFFFFFF
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def plain_dropout_keyed(x: torch.Tensor, words: torch.Tensor, p: float,
                        offset: int = 0) -> torch.Tensor:
    """``x * bernoulli(key, 1 - p, x.shape)`` with plain torch ops,
    the key given as :func:`key_words`; ``offset`` as
    :func:`plain_dropout`'s."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    mask = prng.bernoulli((w[0], w[1]), keep_threshold(p), x.shape,
                          offset=offset)
    return x * mask.to(x.dtype)


# ---------------------------------------------------------------- kernel


def _library():
    lib = _cuda.load("dropout")
    if not getattr(lib, "_bound", False):
        lib.dropout_apply.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_uint, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_void_p]
        lib.dropout_apply.restype = ctypes.c_int
        lib.dropout_apply_keyed.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_float,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.dropout_apply_keyed.restype = ctypes.c_int
        lib.dropout_device_rates.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.dropout_device_rates.restype = ctypes.c_int
        lib.dropout_error_string.argtypes = [ctypes.c_int]
        lib.dropout_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def build() -> None:
    """Build (if needed) and load the kernel library."""
    _library()


def int_ops_per_s(device: int = 0) -> float:
    """The card's peak rate of integer operations: SMs x 128 lanes (the
    issue rate) x SM clock, the SM count and clock read from the
    device's properties."""
    lib = _library()
    sms, khz = ctypes.c_int(), ctypes.c_int()
    err = lib.dropout_device_rates(device, ctypes.byref(sms),
                                   ctypes.byref(khz))
    if err != 0:
        raise RuntimeError("dropout_device_rates: CUDA error %d (%s)"
                           % (err, lib.dropout_error_string(err).decode()))
    return float(sms.value) * INT_LANES_PER_SM * khz.value * 1e3


def _check_x(x):
    enforce(x.dtype in _DTYPES and x.is_contiguous(),
            "dropout: the kernel takes a contiguous float32 or bfloat16 "
            "tensor, got %s (contiguous: %s)" % (x.dtype, x.is_contiguous()))


def _check_cuda(x, counter, counter_out):
    _check_x(x)
    for c in (counter,) + ((counter_out,) if counter_out is not None
                           else ()):
        enforce(c.numel() == 1 and c.dtype == torch.int32
                and c.device == x.device,
                "dropout: the counter must be one int32 element on %s, got "
                "%s %s on %s" % (x.device, c.dtype, tuple(c.shape),
                                 c.device))


# The kernel as a torch.library custom op (see ops/flash_attention.py):
# the CPU kernel is plain_dropout, the CUDA kernel the hand-written one,
# the fake kernel gives tracing the output's shape. ``counter_out`` is
# declared mutated: both kernels write ``counter + 1`` into it.


@torch.library.custom_op("paddle_tpu_torch::dropout_apply",
                         mutates_args=("counter_out",), device_types="cpu")
def _dropout_apply_op(x: torch.Tensor, seed: int, counter: torch.Tensor,
                      p: float, counter_out: Optional[torch.Tensor],
                      backward: bool, offset: int = 0) -> torch.Tensor:
    if counter_out is not None:
        counter_out.copy_(counter.reshape(counter_out.shape) + 1)
    return plain_dropout(x, seed, counter, p, offset)


@_dropout_apply_op.register_fake
def _(x, seed, counter, p, counter_out, backward, offset=0):
    return torch.empty_like(x)


@_dropout_apply_op.register_kernel("cuda")
def _(x, seed, counter, p, counter_out, backward, offset=0):
    _check_cuda(x, counter, counter_out)
    lib = _library()
    out = torch.empty_like(x)
    vec = int(x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dropout_apply(
            int(x.dtype == torch.bfloat16), x.data_ptr(), out.data_ptr(),
            x.numel(), int(seed) & 0xFFFFFFFF, counter.data_ptr(),
            counter_out.data_ptr() if counter_out is not None else None,
            keep_threshold(p), int(offset), vec, stream)
    if err != 0:
        raise RuntimeError("dropout: kernel launch failed: CUDA error %d "
                           "(%s)" % (err, lib.dropout_error_string(err)
                                     .decode()))
    dropout_apply.launches += 1
    if backward:
        dropout_apply.backward_launches += 1
    return out


def dropout_apply(x: torch.Tensor, seed: int, counter: torch.Tensor,
                  p: float, counter_out=None, backward: bool = False,
                  offset: int = 0) -> torch.Tensor:
    """``x * mask`` (a new tensor): the ``dropout_apply`` op — on a CUDA
    tensor one kernel launch, which also writes ``counter + 1`` into
    ``counter_out`` when given; on a CPU tensor :func:`plain_dropout`
    (and ``counter_out`` filled the same way). ``backward`` marks a
    launch for the gradient; ``offset`` (>= 0) draws the mask's
    elements from that flat index on (a rank's block of a sharded
    tensor)."""
    return _dropout_apply_op(x, int(seed), counter, float(p), counter_out,
                             bool(backward), int(offset))


_cuda.register_launcher(dropout_apply,
                        counts=("launches", "backward_launches",
                                "keyed_launches"))


@torch.library.custom_op("paddle_tpu_torch::dropout_apply_keyed",
                         mutates_args=(), device_types="cpu")
def _dropout_keyed_op(x: torch.Tensor, words: torch.Tensor, p: float,
                      backward: bool, offset: int = 0) -> torch.Tensor:
    return plain_dropout_keyed(x, words, p, offset)


@_dropout_keyed_op.register_fake
def _(x, words, p, backward, offset=0):
    return torch.empty_like(x)


@_dropout_keyed_op.register_kernel("cuda")
def _(x, words, p, backward, offset=0):
    _check_x(x)
    enforce(words.numel() == 2 and words.dtype == torch.int32
            and words.device == x.device and words.is_contiguous(),
            "dropout: a key is two int32 words on %s, got %s %s on %s"
            % (x.device, words.dtype, tuple(words.shape), words.device))
    lib = _library()
    out = torch.empty_like(x)
    vec = int(x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dropout_apply_keyed(
            int(x.dtype == torch.bfloat16), x.data_ptr(), out.data_ptr(),
            x.numel(), words.data_ptr(), keep_threshold(p), int(offset),
            vec, stream)
    if err != 0:
        raise RuntimeError("dropout: keyed kernel launch failed: CUDA error "
                           "%d (%s)" % (err, lib.dropout_error_string(err)
                                        .decode()))
    dropout_apply.launches += 1
    dropout_apply.keyed_launches += 1
    if backward:
        dropout_apply.backward_launches += 1
    return out


def dropout_apply_keyed(x: torch.Tensor, words: torch.Tensor, p: float,
                        backward: bool = False,
                        offset: int = 0) -> torch.Tensor:
    """``x * mask`` under the key ``words`` (:func:`key_words`, on
    ``x``'s device): one launch of the kernel on a CUDA tensor (or it
    raises), :func:`plain_dropout_keyed` on a CPU one."""
    return _dropout_keyed_op(x.contiguous(), words, float(p), bool(backward),
                             int(offset))


class _KeyedDropout(torch.autograd.Function):
    """``x * mask`` under a given key; the gradient ``g * mask``, the
    mask drawn again under the same key."""

    @staticmethod
    def forward(ctx, x, words, p, offset):
        ctx.save_for_backward(words)
        ctx.p, ctx.offset = p, offset
        return dropout_apply_keyed(x, words, p, offset=offset)

    @staticmethod
    def backward(ctx, g):
        words, = ctx.saved_tensors
        return (dropout_apply_keyed(g, words, ctx.p, backward=True,
                                    offset=ctx.offset), None, None, None)


def dropout_keyed(x: torch.Tensor, key, p: float, offset: int = 0):
    """``x * bernoulli(key, 1 - p, x.shape)`` for a ``core.prng`` key
    (its words on ``x``'s device), differentiable; ``offset``: ``x`` is
    the elements from that flat index on of a larger tensor."""
    return _KeyedDropout.apply(x, key_words(key).to(x.device), float(p),
                               int(offset))


class _Dropout(torch.autograd.Function):
    """``(x * mask, counter + 1)``; the gradient ``g * mask`` with the
    mask drawn again under the counter the forward read. The counter
    tensor itself is saved, not the scope's: nothing writes it in place
    before the backward pass (a step's state is written back after its
    updates), and autograd's version check would refuse it if something
    did. An autograd Function over the op, not the op's own
    ``register_autograd``: torch registers autograd formulas for
    functional ops only, and ``dropout_apply`` mutates ``counter_out``.
    A trace (``make_fx``) records the op in both passes all the same."""

    @staticmethod
    def forward(ctx, x, counter, seed, p, offset, cols):
        counter_out = torch.empty((), dtype=torch.int32,
                                  device=counter.device)
        ctx.seed, ctx.p, ctx.offset = seed, p, offset
        ctx.mark_non_differentiable(counter_out)
        if cols is not None:
            # a block of columns: the mask of the whole rows, cut
            col0, width = cols
            ones = torch.ones(tuple(x.shape[:-1]) + (width,),
                              dtype=x.dtype, device=x.device)
            mask = dropout_apply(ones, seed, counter, p,
                                 counter_out=counter_out, offset=offset)
            mask = mask[..., col0:col0 + x.shape[-1]]
            ctx.save_for_backward(mask)
            ctx.cols = True
            return x * mask, counter_out
        out = dropout_apply(x.contiguous(), seed, counter, p,
                            counter_out=counter_out, offset=offset)
        ctx.save_for_backward(counter)
        ctx.cols = False
        return out, counter_out

    @staticmethod
    def backward(ctx, g, _):
        saved, = ctx.saved_tensors
        if ctx.cols:
            return g * saved, None, None, None, None, None
        gx = dropout_apply(g.contiguous(), ctx.seed, saved, ctx.p,
                           backward=True, offset=ctx.offset)
        return gx, None, None, None, None, None


def dropout(x: torch.Tensor, seed: int, counter: torch.Tensor,
            p: float, offset: int = 0, cols=None):
    """The dropout op's training branch: ``(x * mask, counter + 1)``,
    the mask keyed on ``fold_in(PRNGKey(seed), counter)``. A rank's
    block of a sharded tensor takes its block of the whole tensor's
    mask: ``offset`` is the flat index of its first element; ``cols`` =
    ``(first column, whole width)`` when ``x`` holds a block of the last
    dimension's columns (``offset`` then counts whole rows)."""
    counter = counter.to(torch.int32)
    return _Dropout.apply(x, counter, int(seed), float(p), int(offset),
                          cols)
