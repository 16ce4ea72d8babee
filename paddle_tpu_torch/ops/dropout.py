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
* :func:`dropout_apply` — the launcher: ``x * mask`` on a CUDA tensor in
  one kernel launch (or raises), the plain version on a CPU tensor. The
  counter is a one-element int32 tensor on ``x``'s device, read by the
  kernel (no host read); ``counter_out``, when given, receives
  ``counter + 1`` from the same launch. It counts its launches in
  ``.launches`` and, of those, the backward pass's in
  ``.backward_launches``.
* :func:`dropout` — the op: ``(x * mask, counter + 1)`` as a
  ``torch.autograd.Function`` whose backward is the kernel on the
  incoming gradient under the counter its forward read (the mask drawn
  again, none stored).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import prng
from ..core.enforce import enforce
from . import _cuda

__all__ = ["dropout", "dropout_apply", "keep_threshold", "plain_dropout"]

_PLAIN_DEVICES = ("cpu", "meta")
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
                  p: float) -> torch.Tensor:
    """``x * bernoulli(fold_in(PRNGKey(seed), counter), 1 - p)`` with
    plain torch ops; ``counter`` is a one-element integer tensor."""
    key = prng.fold_in(prng.prng_key(torch.tensor(int(seed),
                                                  device=counter.device)),
                       counter.reshape(()))
    mask = prng.bernoulli(key, keep_threshold(p), x.shape)
    return x * mask.to(x.dtype)


# ---------------------------------------------------------------- kernel


def _library():
    lib = _cuda.load("dropout")
    if not getattr(lib, "_bound", False):
        lib.dropout_apply.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_uint, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.dropout_apply.restype = ctypes.c_int
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


def _check_cuda(x, counter, counter_out):
    enforce(x.device.type == "cuda", "dropout: unsupported device %s"
            % x.device)
    enforce(x.dtype in _DTYPES and x.is_contiguous(),
            "dropout: the kernel takes a contiguous float32 or bfloat16 "
            "tensor, got %s (contiguous: %s)" % (x.dtype, x.is_contiguous()))
    for c in (counter,) + ((counter_out,) if counter_out is not None
                           else ()):
        enforce(c.numel() == 1 and c.dtype == torch.int32
                and c.device == x.device,
                "dropout: the counter must be one int32 element on %s, got "
                "%s %s on %s" % (x.device, c.dtype, tuple(c.shape),
                                 c.device))


def dropout_apply(x: torch.Tensor, seed: int, counter: torch.Tensor,
                  p: float, counter_out=None,
                  backward: bool = False) -> torch.Tensor:
    """``x * mask`` (a new tensor): on a CUDA tensor one kernel launch,
    which also writes ``counter + 1`` into ``counter_out`` when given;
    on a CPU tensor :func:`plain_dropout` (and ``counter_out`` filled
    the same way). ``backward`` marks a launch for the gradient."""
    if x.device.type in _PLAIN_DEVICES:
        if counter_out is not None:
            counter_out.copy_(counter.reshape(counter_out.shape) + 1)
        return plain_dropout(x, seed, counter, p)
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
            keep_threshold(p), vec, stream)
    if err != 0:
        raise RuntimeError("dropout: kernel launch failed: CUDA error %d "
                           "(%s)" % (err, lib.dropout_error_string(err)
                                     .decode()))
    dropout_apply.launches += 1
    if backward:
        dropout_apply.backward_launches += 1
    return out


_cuda.register_launcher(dropout_apply,
                        counts=("launches", "backward_launches"))


class _Dropout(torch.autograd.Function):
    """``(x * mask, counter + 1)``; the gradient ``g * mask`` with the
    mask drawn again under the counter the forward read. The counter
    tensor itself is saved, not the scope's: nothing writes it in place
    before the backward pass (a step's state is written back after its
    updates), and autograd's version check would refuse it if something
    did."""

    @staticmethod
    def forward(ctx, x, counter, seed, p):
        counter_out = torch.empty((), dtype=torch.int32,
                                  device=counter.device)
        out = dropout_apply(x.contiguous(), seed, counter, p,
                            counter_out=counter_out)
        ctx.save_for_backward(counter)
        ctx.seed, ctx.p = seed, p
        ctx.mark_non_differentiable(counter_out)
        return out, counter_out

    @staticmethod
    def backward(ctx, g, _):
        counter, = ctx.saved_tensors
        gx = dropout_apply(g.contiguous(), ctx.seed, counter, ctx.p,
                           backward=True)
        return gx, None, None, None


def dropout(x: torch.Tensor, seed: int, counter: torch.Tensor,
            p: float):
    """The dropout op's training branch: ``(x * mask, counter + 1)``,
    the mask keyed on ``fold_in(PRNGKey(seed), counter)``."""
    counter = counter.to(torch.int32)
    return _Dropout.apply(x, counter, int(seed), float(p))
