"""The optimizers' dense update over one flat parameter group, as a
hand-written CUDA kernel for Hopper (csrc/fused_optimizer.cu).

Replaces ``fused_flat_update`` of ``paddle_tpu/ops/fused_optimizer.py``
(Pallas kernel ``_kernel``). Under ``fuse_optimizer_state`` the
parameters of a (dtype, grad dtype, lr scale) group and each of their
moments live in one flat ``[N]`` buffer, and one group op updates the
whole group (optimizer.py ``_append_one_group``). The Pallas kernel
streamed those buffers through VMEM in ``[block_rows, 128]`` tiles and
padded a ragged N; here one launch walks the flat buffers with a
grid-stride loop, masks the ragged tail itself and updates the
parameters and moments in place (no padded copies, no output buffers).

Functions:

* :func:`plain_flat_update` — the update with plain torch ops, in the
  op order of the optimizers' per-parameter update (``optimizer.py``
  builds those from it, so the two layouts cannot drift apart). What
  CPU tensors run and what the kernel is held to on the card.
* :func:`fused_flat_update` — the launcher. A CPU tensor takes the
  plain version; a CUDA tensor launches the kernel or raises. It counts
  its launches in ``.launches``.

``kind`` is the optimizer's op type, ``"sgd"``, ``"adagrad"`` or
``"adam"``; ``consts`` its Python-float hyperparameters: ``(scale,)``,
``(scale, eps)`` and ``(scale, beta1, beta2, eps)``, where ``scale`` is
the group's learning-rate scale. Moments are f32 or, under
``bf16_moments``, bf16: they are widened to f32 for the arithmetic and
rounded back to bf16 (nearest even) when stored. Adam's beta powers are
shared by every group; only the owning group (``owns``) returns them
advanced, as new tensors: the kernel reads the step-start value in
every block, so it never advances them in place.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..core.enforce import enforce
from . import _cuda

__all__ = ["KINDS", "fused_flat_update", "plain_flat_update"]

# kind -> (moments, shared scalars, consts): what each update reads
KINDS = {"sgd": (0, 0, 1), "adagrad": (1, 0, 2), "adam": (2, 2, 4)}
_KIND_ID = {"sgd": 0, "adagrad": 1, "adam": 2}
_PLAIN_DEVICES = ("cpu", "meta")
_MOMENT_DTYPES = (torch.float32, torch.bfloat16)


def _f32(a, ref):
    """A stored moment widened to the gradient's dtype: a Python float
    times a bf16 tensor stays bf16 in torch, which would quantize the
    decay (beta2 = 0.999 rounds to 0.9961)."""
    return a if a.dtype == ref.dtype else a.to(ref.dtype)


def plain_flat_update(kind: str, p, g, lr, accs: Sequence = (),
                      shared: Sequence = (), owns: bool = False,
                      consts: Sequence[float] = ()):
    """``(new_p, *new_accs[, *advanced_shared if owns])`` with plain
    torch ops. ``lr`` and ``shared`` are 0-d f32 tensors; the new
    moments come back in their storage dtype."""
    enforce(kind in KINDS, "fused update: unknown kind %r (one of %s)"
            % (kind, sorted(KINDS)))
    if kind == "sgd":
        scale, = consts
        return (p - (lr * scale) * g,)
    if kind == "adagrad":
        scale, eps = consts
        m, = accs
        m_new = m + g * g
        p_new = p - (lr * scale) * g / (torch.sqrt(m_new) + eps)
        return p_new, m_new.to(m.dtype)
    scale, b1, b2, eps = consts
    m1, m2 = accs
    b1p, b2p = shared
    lr = lr * scale
    m1n = b1 * _f32(m1, g) + (1 - b1) * g
    m2n = b2 * _f32(m2, g) + (1 - b2) * g * g
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    p_new = p - lr_t * m1n / (torch.sqrt(m2n) + eps)
    out = (p_new, m1n.to(m1.dtype), m2n.to(m2.dtype))
    return out + (b1p * b1, b2p * b2) if owns else out


# ---------------------------------------------------------------- kernel

# kind, bf16 moments; p, g, lr, m1, m2, b1p, b2p, b1p_out, b2p_out; n;
# scale, beta1, 1-beta1, beta2, 1-beta2, eps; stream
_ARGS = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9 + [ctypes.c_longlong]
         + [ctypes.c_float] * 6 + [ctypes.c_void_p])


def _library():
    lib = _cuda.load("fused_optimizer")
    if not getattr(lib, "_bound", False):
        lib.fused_flat_update.argtypes = _ARGS
        lib.fused_flat_update.restype = ctypes.c_int
        lib.fused_update_error_string.argtypes = [ctypes.c_int]
        lib.fused_update_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def build() -> None:
    """Build (if needed) and load the kernel library."""
    _library()


def _check_cuda(kind, p, g, lr, accs, shared, consts):
    n_acc, n_shared, n_consts = KINDS[kind]
    enforce(len(accs) == n_acc and len(shared) == n_shared
            and len(consts) == n_consts,
            "fused_flat_update(%s): takes %d moments, %d shared scalars and "
            "%d consts; got %d, %d, %d" % (kind, n_acc, n_shared, n_consts,
                                           len(accs), len(shared),
                                           len(consts)))
    dev = p.device
    enforce(dev.type == "cuda", "fused_flat_update: unsupported device %s"
            % dev)
    enforce(p.dim() == 1 and p.dtype == torch.float32 and p.is_contiguous(),
            "fused_flat_update: the parameters must be a contiguous flat "
            "float32 buffer, got %s %s" % (p.dtype, tuple(p.shape)))
    enforce(g.shape == p.shape and g.dtype == torch.float32
            and g.is_contiguous() and g.device == dev,
            "fused_flat_update: the gradient must be contiguous float32 %s "
            "on %s" % (tuple(p.shape), dev))
    for a in accs:
        enforce(a.shape == p.shape and a.dtype in _MOMENT_DTYPES
                and a.dtype == accs[0].dtype and a.is_contiguous()
                and a.device == dev,
                "fused_flat_update: moments must be contiguous %s, all "
                "float32 or all bfloat16, on %s" % (tuple(p.shape), dev))
    for s in (lr,) + tuple(shared):
        enforce(s.numel() == 1 and s.dtype == torch.float32
                and s.device == dev,
                "fused_flat_update: lr and shared scalars must be one "
                "float32 element on %s" % dev)


def fused_flat_update(kind: str, p, g, lr, accs: Sequence = (),
                      shared: Sequence = (), owns: bool = False,
                      consts: Sequence[float] = ()):
    """The group update: on a CUDA tensor one kernel launch that updates
    ``p`` and ``accs`` in place and returns them (and, if ``owns``, the
    advanced shared scalars as new tensors); on a CPU tensor
    :func:`plain_flat_update`."""
    accs, shared, consts = tuple(accs), tuple(shared), tuple(consts)
    if p.device.type in _PLAIN_DEVICES:
        return plain_flat_update(kind, p, g, lr, accs, shared, owns, consts)
    enforce(kind in KINDS, "fused update: unknown kind %r (one of %s)"
            % (kind, sorted(KINDS)))
    _check_cuda(kind, p, g, lr, accs, shared, consts)
    lib = _library()
    scale, eps = float(consts[0]), float(consts[-1])
    b1, b2 = (float(c) for c in consts[1:3]) if kind == "adam" else (0., 0.)
    adv = tuple(torch.empty_like(s) for s in shared) if owns else ()
    # null pointers for what this kind does not read or write
    ptrs = [t.data_ptr() if t is not None else None
            for part in (accs, shared, adv)
            for t in (part + (None, None))[:2]]
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_flat_update(
            _KIND_ID[kind], int(bool(accs) and accs[0].dtype
                                == torch.bfloat16),
            p.data_ptr(), g.data_ptr(), lr.data_ptr(), *ptrs, p.numel(),
            # the constants as Python computes them, in double, then
            # rounded to float32 as torch's scalar ops round them (SGD's
            # eps slot is its scale and unused)
            scale, b1, 1.0 - b1, b2, 1.0 - b2, eps, stream)
    if err != 0:
        raise RuntimeError("fused_flat_update: kernel launch failed: CUDA "
                           "error %d (%s)"
                           % (err, lib.fused_update_error_string(err)
                              .decode()))
    fused_flat_update.launches += 1
    return (p,) + accs + adv


_cuda.register_launcher(fused_flat_update)
