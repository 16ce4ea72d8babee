"""The optimizers' dense update over one flat parameter group, as a
hand-written CUDA kernel for Hopper (csrc/fused_optimizer.cu).

Replaces ``fused_flat_update`` of ``paddle_tpu/ops/fused_optimizer.py``
(Pallas kernel ``_kernel``). Under ``fuse_optimizer_state`` the
parameters of a (dtype, grad dtype, lr scale) group and each of their
moments live in one flat ``[N]`` buffer, and one group op updates the
whole group (optimizer.py ``_append_one_group``). The Pallas kernel
streamed those buffers through VMEM in ``[block_rows, 128]`` tiles,
applied whatever ``_make_update_fn`` the optimizer handed it and padded
a ragged N; here one launch walks the flat buffers with a grid-stride
loop, applies one of the update functions below (its ``kind``), masks
the ragged tail itself and updates the parameters and moments in place
(no padded copies, no output buffers).

Functions:

* :func:`plain_flat_update` — the update with plain torch ops, in the
  op order of the JAX package's ``_make_update_fn`` of each optimizer
  (``optimizer.py`` builds its per-parameter ops from it, so the two
  layouts cannot drift apart). What CPU tensors run and what the kernel
  is held to on the card.
* :func:`fused_flat_update` — the ``paddle_tpu_torch::fused_flat_update``
  custom op, which updates ``p`` and the moments in place on either
  device: a CPU tensor takes the plain version, a CUDA tensor launches
  the kernel or raises. It counts its launches in ``.launches``, and
  those gated on a flag in ``.gated_launches``.

The kernel's one launch knob is its grid cap: at most ``blocks_per_sm``
x 132 blocks of 256 threads, the grid-stride loop covering the rest
(the JAX kernel's knob was its ``[block_rows, 128]`` tile height). It
changes no arithmetic. ``fused_flat_update(blocks_per_sm=None)`` reads
it from ``paddle_tpu_torch.tuning.lookup`` (the
``fused_optimizer_update`` tunable; default 16) at each launch.

Both take an optional ``apply`` flag, a 0-d bool tensor on the
parameters' device (the JAX package's ``mask_update_op``: the overflow
skip of ``amp.decorate``, the k-th micro-step of
``GradientAccumulation``). Where it is false every output keeps its
input: the parameters and moments are left as they were, and the owning
group's advanced scalars come out at their step-start values. The plain
version takes ``torch.where`` over its outputs; the kernel reads the
flag from the card once per block and writes nothing when it is false,
so a captured step skips an overflowed update without a host sync.
Where it is true both give the bits of the ungated update.

``kind`` is the optimizer's op type; ``consts`` its hyperparameters as
Python numbers, ``scale`` (the group's learning-rate scale) first:

=================== ======= ====== ==========================================
kind                moments shared consts
=================== ======= ====== ==========================================
``sgd``             0       0      ``(scale,)``
``adagrad``         1       0      ``(scale, eps)``
``adam``            2       2      ``(scale, beta1, beta2, eps)``
``momentum``        1       0      ``(scale, mu, use_nesterov)``
``adamax``          2       1      ``(scale, beta1, beta2, eps)``
``decayed_adagrad`` 1       0      ``(scale, decay, eps)``
``adadelta``        2       0      ``(scale, rho, eps)``
``rmsprop``         3       0      ``(scale, rho, eps, momentum, centered)``
``ftrl``            2       0      ``(scale, l1, l2, lr_power)``
``proximal_gd``     0       0      ``(scale, l1, l2)``
``proximal_adagrad`` 1      0      ``(scale, l1, l2)``
=================== ======= ====== ==========================================

Moments are f32 or, under ``bf16_moments``, bf16, and come back in
their storage dtype (rounded to nearest even). Where the JAX update
widens a stored moment first (``_acc``), so does the plain version;
where it does not (Adagrad, ProximalAdagrad, Ftrl), the bf16 moment
meets the f32 gradient and the sum is f32 in both frameworks. Ftrl's
``sqrt``/``power`` of its stored ``squared`` moment is taken in f32 too:
eagerly JAX would round it to bf16, but the JAX package's step is
jitted, and XLA drops a bf16 rounding between two converts (only the
power's exponent stays a bf16 constant). The shared
scalars (Adam's two beta powers, Adamax's one) are shared by every
group; only the owning group (``owns``) returns them advanced, as new
tensors: the kernel reads the step-start value in every block, so it
never advances them in place.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from ..core.enforce import enforce
from . import _cuda

__all__ = ["KINDS", "fused_flat_update", "plain_flat_update"]

# kind -> (moments, shared scalars, consts): what each update reads
KINDS = {"sgd": (0, 0, 1), "adagrad": (1, 0, 2), "adam": (2, 2, 4),
         "momentum": (1, 0, 3), "adamax": (2, 1, 4),
         "decayed_adagrad": (1, 0, 3), "adadelta": (2, 0, 3),
         "rmsprop": (3, 0, 5), "ftrl": (2, 0, 4), "proximal_gd": (0, 0, 3),
         "proximal_adagrad": (1, 0, 3)}
# the kernel's kind ids (csrc/fused_optimizer.cu, enum Kind)
_KIND_ID = {k: i for i, k in enumerate(KINDS)}
_MOMENT_DTYPES = (torch.float32, torch.bfloat16)
# the C interface's fixed array lengths
_MAX_MOMENTS, _MAX_SHARED, _MAX_CONSTS = 4, 2, 8
# the grid cap's default, blocks an SM (tuning/kernels.py's default)
DEFAULT_BLOCKS_PER_SM = 16


def _f32(a, ref):
    """A stored moment widened to the gradient's dtype (the JAX
    package's ``_acc``): a Python float times a bf16 tensor stays bf16
    in torch, which would quantize the decay (beta2 = 0.999 rounds to
    0.9961)."""
    return a if a.dtype == ref.dtype else a.to(ref.dtype)


def _bf16_exponent(e: float) -> float:
    """``e`` rounded to bf16: the exponent the JAX package gives the
    power of a bf16 tensor (a Python float meeting a bf16 array is a bf16
    weak type, folded into a bf16 constant)."""
    return float(torch.tensor(e, dtype=torch.float64).to(torch.bfloat16))


def _prox(prox, lr, l1, l2):
    """``sign(prox) * max(|prox| - lr*l1, 0) / (1 + lr*l2)``, the
    proximal step of ProximalGD and ProximalAdagrad."""
    return (torch.sign(prox) * torch.clamp(torch.abs(prox) - lr * l1,
                                           min=0.0)) / (1.0 + lr * l2)


def plain_flat_update(kind: str, p, g, lr, accs: Sequence = (),
                      shared: Sequence = (), owns: bool = False,
                      consts: Sequence = (), apply=None):
    """``(new_p, *new_accs[, *advanced_shared if owns])`` with plain
    torch ops. ``lr`` and ``shared`` are 0-d f32 tensors; the new
    moments come back in their storage dtype. ``apply`` (a 0-d bool
    tensor, or None) gates every output on its input."""
    enforce(kind in KINDS, "fused update: unknown kind %r (one of %s)"
            % (kind, sorted(KINDS)))
    accs, shared = tuple(accs), tuple(shared)
    out = _PLAIN[kind](p, g, lr * consts[0], accs, shared, *consts[1:])
    out = (out[0],) + tuple(v.to(a.dtype) for v, a in zip(out[1:], accs))
    if owns:
        # the shared beta powers advance by their betas (consts 1, 2)
        out += tuple(s * b for s, b in zip(shared, consts[1:]))
    if apply is not None:
        ins = (p,) + accs + (shared if owns else ())
        out = tuple(torch.where(apply, o, i) for o, i in zip(out, ins))
    return out


def _sgd(p, g, lr, accs, shared):
    return (p - lr * g,)


def _adagrad(p, g, lr, accs, shared, eps):
    m, = accs
    m_new = m + g * g
    return p - lr * g / (torch.sqrt(m_new) + eps), m_new


def _adam(p, g, lr, accs, shared, b1, b2, eps):
    m1, m2 = accs
    b1p, b2p = shared
    m1n = b1 * _f32(m1, g) + (1 - b1) * g
    m2n = b2 * _f32(m2, g) + (1 - b2) * g * g
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    return p - lr_t * m1n / (torch.sqrt(m2n) + eps), m1n, m2n


def _momentum(p, g, lr, accs, shared, mu, nesterov):
    v, = accs
    v_new = mu * _f32(v, g) + g
    if nesterov:
        return p - (g + mu * v_new) * lr, v_new
    return p - lr * v_new, v_new


def _adamax(p, g, lr, accs, shared, b1, b2, eps):
    m, inf = accs
    b1p, = shared
    m_new = b1 * _f32(m, g) + (1 - b1) * g
    inf_new = torch.maximum(b2 * _f32(inf, g), torch.abs(g) + eps)
    lr_t = lr / (1 - b1p)
    return p - lr_t * m_new / inf_new, m_new, inf_new


def _decayed_adagrad(p, g, lr, accs, shared, decay, eps):
    m, = accs
    m_new = decay * _f32(m, g) + (1 - decay) * g * g
    return p - lr * g / (torch.sqrt(m_new) + eps), m_new


def _adadelta(p, g, lr, accs, shared, rho, eps):
    asg, asu = (_f32(a, g) for a in accs)
    asg_new = rho * asg + (1 - rho) * g * g
    update = -torch.sqrt((asu + eps) / (asg_new + eps)) * g
    asu_new = rho * asu + (1 - rho) * update * update
    return p + lr * update, asg_new, asu_new


def _rmsprop(p, g, lr, accs, shared, rho, eps, mu, centered):
    mom, ms, mg = (_f32(a, g) for a in accs)
    ms_new = rho * ms + (1 - rho) * g * g
    if centered:
        mg_new = rho * mg + (1 - rho) * g
        denom = torch.sqrt(ms_new - mg_new * mg_new + eps)
    else:
        mg_new = mg  # unchanged: the kernel neither reads nor writes it
        denom = torch.sqrt(ms_new + eps)
    mom_new = mu * mom + lr * g / denom
    return p - mom_new, mom_new, ms_new, mg_new


def _ftrl(p, g, lr, accs, shared, l1, l2, lr_power):
    # the JAX package's Ftrl does not widen its moments, but its jitted
    # step computes sqrt/power of a bf16 ``squared`` in f32 all the same
    # (XLA drops the bf16 rounding between a convert and its inverse);
    # only the power's exponent stays rounded to bf16
    sq, lin = accs
    new_sq = sq + g * g
    sq_f = _f32(sq, g)
    if lr_power == -0.5:
        sigma = (torch.sqrt(new_sq) - torch.sqrt(sq_f)) / lr
        y = torch.sqrt(new_sq) / lr + 2 * l2
    else:
        e = -lr_power
        e_sq = _bf16_exponent(e) if sq.dtype == torch.bfloat16 else e
        sigma = (torch.pow(new_sq, e) - torch.pow(sq_f, e_sq)) / lr
        y = torch.pow(new_sq, e) / lr + 2 * l2
    lin_new = lin + g - sigma * p
    x = l1 * torch.sign(lin_new) - lin_new
    p_new = torch.where(torch.abs(lin_new) > l1, x / y, torch.zeros_like(p))
    return p_new, new_sq, lin_new


def _proximal_gd(p, g, lr, accs, shared, l1, l2):
    return (_prox(p - lr * g, lr, l1, l2),)


def _proximal_adagrad(p, g, lr, accs, shared, l1, l2):
    m, = accs
    m_new = m + g * g
    eff = lr / torch.sqrt(m_new + 1e-12)
    return _prox(p - eff * g, eff, l1, l2), m_new


_PLAIN = {"sgd": _sgd, "adagrad": _adagrad, "adam": _adam,
          "momentum": _momentum, "adamax": _adamax,
          "decayed_adagrad": _decayed_adagrad, "adadelta": _adadelta,
          "rmsprop": _rmsprop, "ftrl": _ftrl, "proximal_gd": _proximal_gd,
          "proximal_adagrad": _proximal_adagrad}


def kernel_consts(kind: str, consts: Sequence):
    """(variant, floats) the kernel takes for ``consts``: the branch
    (Nesterov, centered, ``lr_power == -0.5``) as 0/1, and the constants
    the plain version's scalar operands carry, as Python computes them
    (in double) before torch rounds them to float32."""
    c = [float(x) for x in consts]
    scale = c[0]
    if kind == "sgd":
        return 0, [scale]
    if kind == "adagrad":
        return 0, [scale, c[1]]
    if kind == "adam":
        b1, b2, eps = c[1:]
        return 0, [scale, b1, 1 - b1, b2, 1 - b2, eps]
    if kind == "momentum":
        return int(bool(consts[2])), [scale, c[1]]
    if kind == "adamax":
        b1, b2, eps = c[1:]
        return 0, [scale, b1, 1 - b1, b2, eps]
    if kind in ("decayed_adagrad", "adadelta"):
        decay, eps = c[1:]
        return 0, [scale, decay, 1 - decay, eps]
    if kind == "rmsprop":
        rho, eps, mu = c[1:4]
        return int(bool(consts[4])), [scale, rho, 1 - rho, eps, mu]
    if kind == "ftrl":
        l1, l2, lrp = c[1:]
        e = -lrp
        return int(lrp == -0.5), [scale, l1, 2 * l2, e, _bf16_exponent(e)]
    if kind == "proximal_gd":
        return 0, [scale, c[1], c[2]]
    return 0, [scale, c[1], c[2], 1e-12]  # proximal_adagrad


# ---------------------------------------------------------------- kernel

_PTRS = ctypes.c_void_p * _MAX_MOMENTS
_SHARED = ctypes.c_void_p * _MAX_SHARED
_CONSTS = ctypes.c_float * _MAX_CONSTS
# kind, variant, bf16 moments; p, g, lr; moments[4], n moments;
# shared[2], shared_out[2], n shared; n; consts[8], n consts; the apply
# flag (null: ungated); blocks an SM (the grid cap); stream
_ARGS = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
         + [_PTRS, ctypes.c_int, _SHARED, _SHARED, ctypes.c_int,
            ctypes.c_longlong, _CONSTS, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p])


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


def _check_cuda(kind, p, g, lr, accs, shared, consts, apply):
    n_acc, n_shared, n_consts = KINDS[kind]
    enforce(len(accs) == n_acc and len(shared) == n_shared
            and len(consts) == n_consts,
            "fused_flat_update(%s): takes %d moments, %d shared scalars and "
            "%d consts; got %d, %d, %d" % (kind, n_acc, n_shared, n_consts,
                                           len(accs), len(shared),
                                           len(consts)))
    dev = p.device
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
    enforce(apply is None or (apply.numel() == 1
                              and apply.dtype == torch.bool
                              and apply.device == dev),
            "fused_flat_update: the apply flag must be one bool element on "
            "%s" % dev)


# The kernel as a torch.library custom op (see ops/flash_attention.py):
# ``p`` and ``accs`` are declared mutated and updated in place by both
# kernels (the CPU one copies plain_flat_update's new tensors into
# them), and so is ``shared_out``: the buffers, empty or fresh from the
# wrapper, that receive the advanced shared scalars when the group owns
# them. The op returns nothing. ``apply`` is the optional gate, read on
# the parameters' device.


@torch.library.custom_op("paddle_tpu_torch::fused_flat_update",
                         mutates_args=("p", "accs", "shared_out"),
                         device_types="cpu")
def _fused_flat_update_op(kind: str, p: torch.Tensor, g: torch.Tensor,
                          lr: torch.Tensor, accs: List[torch.Tensor],
                          shared: List[torch.Tensor],
                          shared_out: List[torch.Tensor],
                          consts: List[float],
                          apply: Optional[torch.Tensor] = None,
                          blocks_per_sm: Optional[int] = None) -> None:
    out = plain_flat_update(kind, p, g, lr, accs, shared, bool(shared_out),
                            consts, apply)
    for dst, src in zip([p] + list(accs) + list(shared_out), out):
        dst.copy_(src)


@_fused_flat_update_op.register_fake
def _(kind, p, g, lr, accs, shared, shared_out, consts, apply=None,
      blocks_per_sm=None):
    return None


def tuning_problem(p, accs, shared) -> dict:
    """The ``fused_optimizer_update`` tuning problem of a launch (the
    JAX package's: the group's size and its moment and shared-scalar
    counts)."""
    return {"numel": int(p.numel()), "n_accs": len(accs),
            "n_shared": len(shared)}


@_fused_flat_update_op.register_kernel("cuda")
def _(kind, p, g, lr, accs, shared, shared_out, consts, apply=None,
      blocks_per_sm=None):
    _check_cuda(kind, p, g, lr, accs, shared, consts, apply)
    if blocks_per_sm is None:
        from .. import tuning

        blocks_per_sm = tuning.lookup(
            "fused_optimizer_update", tuning_problem(p, accs, shared),
            dtype="float32", device=p.device).get("blocks_per_sm",
                                                  DEFAULT_BLOCKS_PER_SM)
    enforce(int(blocks_per_sm) >= 1,
            "fused_flat_update: blocks_per_sm must be >= 1, got %r"
            % (blocks_per_sm,))
    lib = _library()
    variant, floats = kernel_consts(kind, consts)
    # null pointers for the slots this kind does not read or write
    moments = _PTRS(*[a.data_ptr() for a in accs])
    sh = _SHARED(*[s.data_ptr() for s in shared])
    sh_out = _SHARED(*[s.data_ptr() for s in shared_out])
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_flat_update(
            _KIND_ID[kind], variant,
            int(bool(accs) and accs[0].dtype == torch.bfloat16),
            p.data_ptr(), g.data_ptr(), lr.data_ptr(), moments, len(accs),
            sh, sh_out, len(shared_out), p.numel(), _CONSTS(*floats),
            len(floats), None if apply is None else apply.data_ptr(),
            int(blocks_per_sm), stream)
    if err != 0:
        raise RuntimeError("fused_flat_update: kernel launch failed: CUDA "
                           "error %d (%s)"
                           % (err, lib.fused_update_error_string(err)
                              .decode()))
    fused_flat_update.launches += 1
    if apply is not None:
        fused_flat_update.gated_launches += 1


def fused_flat_update(kind: str, p, g, lr, accs: Sequence = (),
                      shared: Sequence = (), owns: bool = False,
                      consts: Sequence = (), apply=None,
                      blocks_per_sm: Optional[int] = None):
    """The group update, the ``fused_flat_update`` op: one kernel launch
    on a CUDA tensor, :func:`plain_flat_update` on a CPU one; either
    updates ``p`` and ``accs`` in place. Returns ``(p, *accs)`` and, if
    ``owns``, the advanced shared scalars as new tensors. ``apply`` (a
    0-d bool tensor, or None) gates the update: where it is false
    nothing changes and the advanced scalars are the step-start ones.
    ``blocks_per_sm`` caps the kernel's grid at that many blocks an SM
    (None: the tuned cap, by default 16)."""
    enforce(kind in KINDS, "fused update: unknown kind %r (one of %s)"
            % (kind, sorted(KINDS)))
    accs, shared = tuple(accs), tuple(shared)
    adv = tuple(torch.empty_like(s) for s in shared) if owns else ()
    _fused_flat_update_op(kind, p, g, lr, list(accs), list(shared),
                          list(adv), [float(c) for c in consts], apply,
                          blocks_per_sm)
    return (p,) + accs + adv


_cuda.register_launcher(fused_flat_update, ("launches", "gated_launches"))
