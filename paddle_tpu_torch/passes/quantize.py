"""Int8 quantization: QAT (training + freeze) and post-training (PTQ)
(counterpart of paddle_tpu/passes/quantize.py: the same passes, names,
attrs, stamps and ``@INT8`` weights).

Reference lineage: the fluid QAT flow — fake_quantize_op.cc /
fake_dequantize_op.cc inserted by the contrib quantize transpiler, then
a freeze step folding settled scales into integer weights — extended
with the post-training scheme of Jacob et al. (CVPR 2018): per-channel
weight scales, activation scales calibrated from a representative
batch, int8×int8→int32 MACs with one f32 rescale per op.

Two entry paths:

* **QAT** — :class:`QuantizeTranspiler`: ``training_transpile`` wraps
  parameterized ``mul`` ops in the straight-through-estimator
  quant/dequant pattern BEFORE ``minimize``; ``freeze_program`` (the
  registered ``quantize_inference`` pass) bakes the settled
  range-window scales into real int8 weights.

* **PTQ** (the serving path) — no retraining: :func:`calibrate_program`
  runs the f32 program over a representative feed set recording
  per-activation absmax (or a moving average of it), then
  :class:`QuantizePass` rewrites every parameterized
  ``mul``/``matmul``/``conv2d`` onto REAL int8 weights with PER-CHANNEL
  scales — ``quant(act) → int8 MAC (int32 accumulation) → one f32
  rescale`` — while every deny-listed op (softmax, norms, losses,
  lookups: the AMP policy's f32 set) keeps its f32 inputs: each
  quantized op dequantizes its own output, so the surrounding graph
  stays f32. :func:`quantize_for_serving` composes calibrate + rewrite
  through the checked and stamped :class:`~paddle_tpu_torch.passes.
  PassManager`, so the result self-lints to zero diagnostics and
  carries the ``_passes_stamp`` that keys the compile cache's exports.

The int8 ops, on every device alike:

* ``quantize_act`` computes ``round(x * c)`` clipped to ±B, with ``c``
  the f32 product of the f32 reciprocal of the scale and B: what XLA
  compiles the JAX package's ``x / s * B`` with a constant ``s`` to (a
  division by a constant becomes a product with its reciprocal, and the
  two constants fold), so ties round alike in both packages.
* ``int8_mul_dequant`` and ``int8_conv_dequant`` accumulate int8 codes
  in int32 with ``torch._int_mm`` — exact, so equal codes give equal
  sums on the CPU and on the card — then multiply by the f32 rescale
  once. ``_int_mm`` on CUDA wants more than 16 rows and a contraction
  and a width that are multiples of 8: the operands are padded with
  zero rows and columns (exact) and the result sliced. The conv
  gathers its input windows (im2col over int8 codes) into one such
  product; torch has no int8 convolution on CUDA, and a float one of
  the codes is not exact (a 3x3x512 sum reaches 4608 x 127² ≈ 7.4e7,
  past f32's 2^24).

Weights are quantized on the host in numpy, as the JAX package does,
and the int8 weight is stored back on the device the f32 weight lies
on.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import unique_name
from ..core.enforce import enforce
from ..core.program import Block, Operator, Program
from ..core.scope import Scope, global_scope
from ..layers.quantize import _floor_max, _quantize
from .base import Pass, register_pass

_QAT_DEQUANT = "fake_dequantize_qat"

#: op families the PTQ rewrite targets by default (fc lowers to "mul";
#: "matmul" is included for weight-carrying matmuls without transpose)
DEFAULT_INT8_OP_TYPES = ("mul", "matmul", "conv2d")


def _bound(bit_length: int) -> float:
    return float(2 ** (bit_length - 1) - 1)


def _host_f32(value) -> np.ndarray:
    """A scope value as a host numpy array (a card tensor copied back;
    bfloat16 widened to float32, which numpy lacks)."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(value)


def _store(scope: Scope, name: str, value: np.ndarray, like) -> None:
    """``value`` into ``scope[name]`` on the device ``like`` lies on."""
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    scope.set_var(name, torch.from_numpy(np.ascontiguousarray(value))
                  .to(device))


# ---------------------------------------------------------------------------
# QAT: training-time fake quant + freeze (the Fluid-lineage flow)
# ---------------------------------------------------------------------------


class QuantizeTranspiler:
    """reference: the contrib quantize transpiler driving
    fake_quantize_op.cc / fake_dequantize_op.cc."""

    def __init__(self, bit_length: int = 8, window_size: int = 10000):
        self.bit_length = bit_length
        self.window_size = window_size

    # -- training ----------------------------------------------------------
    def training_transpile(self, program: Program,
                           startup_program: Program) -> None:
        """In-place: wrap each ``mul`` whose Y is a persistable parameter
        in the QAT quant/dequant pattern. Call BEFORE minimize()."""
        gb = program.global_block()
        sb = startup_program.global_block()
        B = _bound(self.bit_length)
        W = self.window_size
        # the dequantizer's division by B*B, a product with the f32
        # reciprocal, as XLA compiles the JAX package's constant divisor
        inv_b2 = float(np.float32(1.0) / np.float32(B * B))

        i = 0
        while i < len(gb.ops):
            op = gb.ops[i]
            if op.type != "mul":
                i += 1
                continue
            x_name, w_name = op.input("X")[0], op.input("Y")[0]
            out_name = op.output("Out")[0]
            wv = gb._find_var_recursive(w_name)
            if wv is None or not wv.persistable:
                i += 1
                continue

            def tmp(stem, dtype="float32", shape=None):
                name = unique_name.generate(stem)
                gb.create_var(name=name, dtype=dtype, shape=shape)
                return name

            def state(stem, shape, value, dtype):
                name = unique_name.generate(stem)
                gb.create_var(name=name, shape=shape, dtype=dtype,
                              persistable=True)
                sb.create_var(name=name, shape=shape, dtype=dtype,
                              persistable=True)
                tdt = getattr(torch, dtype)
                sb.append_op(
                    type="fill_constant", inputs={},
                    outputs={"Out": [name]}, attrs={"value": value},
                    fn=lambda _s=tuple(shape), _v=value, _d=tdt:
                        torch.full(_s, _v, dtype=_d))
                return name

            win = state("quant_range_window", (W,), 0.0, "float32")
            it = state("quant_range_iter", (), 0, "int32")
            xq, sx = tmp("quant_act"), tmp("quant_act_scale")
            wq, sw = tmp("quant_w"), tmp("quant_w_scale")
            ymul = tmp("quant_mul_out")

            def q_act(x, scales, itv, is_test=False, _B=B, _W=W):
                if not is_test:
                    slot = torch.arange(_W, device=x.device) == (itv % _W)
                    scales = torch.where(slot, _floor_max(torch.abs(x)),
                                         scales)
                    itv = itv + 1
                s = _floor_max(scales)
                # out stays in the quantized RANGE (x/s*B rounded), with a
                # straight-through gradient of d(x/s*B)/dx
                return _quantize(x, s, _B), s, scales.detach(), itv

            def q_w(w, _B=B):
                s = _floor_max(torch.abs(w))
                return _quantize(w, s, _B), s

            def deq(y, sxv, swv, _r=inv_b2):
                return y * (sxv * swv) * _r

            new_ops = [
                Operator(gb, "fake_quantize_range_abs_max",
                         inputs={"X": [x_name], "InScales": [win],
                                 "Iter": [it]},
                         outputs={"Out": [xq], "OutScale": [sx],
                                  "OutScales": [win], "IterOut": [it]},
                         attrs={"bit_length": self.bit_length,
                                "is_test": False, "_fn_attrs": ["is_test"]},
                         fn=q_act),
                Operator(gb, "fake_quantize_abs_max",
                         inputs={"X": [w_name]},
                         outputs={"Out": [wq], "OutScale": [sw]},
                         attrs={"bit_length": self.bit_length}, fn=q_w),
                Operator(gb, "mul", inputs={"X": [xq], "Y": [wq]},
                         outputs={"Out": [ymul]}, attrs=dict(op.attrs),
                         fn=op.fn),
                Operator(gb, _QAT_DEQUANT,
                         inputs={"X": [ymul], "SX": [sx], "SW": [sw]},
                         outputs={"Out": [out_name]},
                         attrs={"bit_length": self.bit_length,
                                "weight": w_name, "window": win,
                                "activation": x_name}, fn=deq),
            ]
            gb.ops[i:i + 1] = new_ops
            program._bump()
            i += len(new_ops)

    # -- inference ---------------------------------------------------------
    def freeze_program(self, program: Program,
                       scope: Optional[Scope] = None) -> Program:
        """QAT program -> int8-executing inference program.

        Returns a rewritten clone; stores each quantized weight in the
        scope as a real int8 tensor under ``<name>@INT8`` and bakes the
        settled activation scale (max over the QAT range window, exactly
        what the runtime quantizer computed) into the op — matching the
        reference freeze, where deploy scales are constants."""
        scope = scope or global_scope()
        out = program.clone(for_test=True)
        gb = out.global_block()
        B = _bound(self.bit_length)

        i = 0
        while i < len(gb.ops):
            op = gb.ops[i]
            if op.type != _QAT_DEQUANT:
                i += 1
                continue
            # the QAT pattern is spliced consecutively by training_transpile
            enforce(i >= 3
                    and gb.ops[i - 3].type == "fake_quantize_range_abs_max"
                    and gb.ops[i - 2].type == "fake_quantize_abs_max"
                    and gb.ops[i - 1].type == "mul",
                    "freeze_program: QAT pattern around %r was reordered"
                    % op.type)
            q_act_op = gb.ops[i - 3]
            x_name = q_act_op.input("X")[0]
            w_name = op.attrs["weight"]
            win_name = op.attrs["window"]
            out_name = op.output("Out")[0]
            enforce(scope.has_var(w_name) and scope.has_var(win_name),
                    "freeze_program needs trained weights + QAT range "
                    "state in the scope (run QAT first)")

            w_val = scope.get(w_name)
            w = _host_f32(w_val)
            sx = float(max(np.max(_host_f32(scope.get(win_name))), 1e-8))
            sw = float(max(np.max(np.abs(w)), 1e-8))
            w8 = np.clip(np.round(w / sw * B), -B, B).astype(np.int8)
            w8_name = w_name + "@INT8"
            gb.create_var(name=w8_name, shape=list(w8.shape), dtype="int8",
                          persistable=True)
            _store(scope, w8_name, w8, w_val)

            xq8_name = unique_name.generate("quant_act_int8")
            gb.create_var(name=xq8_name, dtype="int8")
            rescale = sx * sw / (B * B)

            new_ops = [
                Operator(gb, "quantize_act", inputs={"X": [x_name]},
                         outputs={"Out": [xq8_name]},
                         attrs={"scale": sx, "bit_length": self.bit_length},
                         fn=_quant_act_fn(sx, B)),
                Operator(gb, "int8_mul_dequant",
                         inputs={"X": [xq8_name], "Y": [w8_name]},
                         outputs={"Out": [out_name]},
                         attrs={"rescale": rescale},
                         fn=_int8_mul_fn(rescale)),
            ]
            gb.ops[i - 3:i + 1] = new_ops
            out._bump()
            i -= 1
        return out


@register_pass("quantize_inference")
class QuantizeInferencePass(Pass):
    """Freeze a QAT program into int8 execution: settled activation
    scales baked in, weights re-stored as int8, matmuls emitted as
    int8 x int8 -> int32 products (wraps
    QuantizeTranspiler.freeze_program; reference: fake_quantize_op.cc /
    fake_dequantize_op.cc feeding the contrib quantize freeze step)."""

    mutates_scope = True
    reads = frozenset({_QAT_DEQUANT, "fake_quantize_range_abs_max",
                       "fake_quantize_abs_max", "mul"})
    writes = frozenset({"quantize_act", "int8_mul_dequant"})

    def __init__(self, bit_length: int = 8):
        self.bit_length = bit_length

    def fingerprint(self) -> str:
        return f"{self.name}/b{int(self.bit_length)}"

    def apply(self, program: Program, scope=None) -> Program:
        return QuantizeTranspiler(bit_length=self.bit_length) \
            .freeze_program(program, scope=scope)


# ---------------------------------------------------------------------------
# the int8 op fns (shared by QAT freeze and PTQ)
# ---------------------------------------------------------------------------


def _device_vector(cache: dict, values: np.ndarray, like: torch.Tensor):
    """``values`` (f32) as a tensor on ``like``'s device, made once per
    device and kept in ``cache``, so a captured graph copies nothing
    from the host; made anew where ``like`` is a meta or fake tensor
    (shape inference, an export's trace)."""
    from torch._subclasses.fake_tensor import is_fake

    if like.device.type == "meta" or is_fake(like):
        return torch.tensor(values.tolist(), dtype=torch.float32,
                            device=like.device).reshape(values.shape)
    key = str(like.device)
    t = cache.get(key)
    if t is None:
        t = cache[key] = torch.from_numpy(values.copy()).to(like.device)
    return t


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``t`` (2-D) padded with zeros to at least ``rows`` x ``cols``."""
    dr, dc = rows - t.shape[0], cols - t.shape[1]
    if dr <= 0 and dc <= 0:
        return t
    return F.pad(t, (0, max(dc, 0), 0, max(dr, 0)))


def int8_matmul(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x2 [M, K] @ w [K, N]`` of int8 codes, accumulated exactly in
    int32 by ``torch._int_mm``. The operands are padded to what the CUDA
    path accepts (M > 16; K and N multiples of 8) with zeros — exact —
    and the product sliced back; the CPU takes the same padded product.
    ``w`` goes in column-major (a transposed copy of the weight, which
    is stored row-major as in the JAX package): cuBLASLt's int8 tensor
    core path takes it so, and a row-major one falls back to a CUTLASS
    kernel 3-5x slower on an H100 (PERF.md)."""
    M, K = x2.shape
    N = w.shape[1]
    Mp, Kp, Np = max(M, 17), -(-K // 8) * 8, -(-N // 8) * 8
    wt = _pad_to(w, Kp, Np).t().contiguous().t()
    y = torch._int_mm(_pad_to(x2.contiguous(), Mp, Kp), wt)
    if (Mp, Np) != (M, N):
        y = y[:M, :N]
    return y


def _quant_act_fn(scale: float, B: float):
    """f32 activation -> int8 codes at one baked scale: ``round(x * c)``
    clipped to ±B with ``c = f32(f32(1 / f32(scale)) * B)`` — XLA's
    compiled form of the JAX package's ``x / scale * B`` (module
    docstring)."""
    c = float(np.float32(np.float32(1.0) / np.float32(scale))
              * np.float32(B))

    def fn(x, _c=c, _B=B):
        y = torch.mul(x, _c)
        return y.round_().clamp_(-_B, _B).to(torch.int8)

    return fn


def _int8_mul_fn(rescale):
    """int8 X @ int8 W -> int32 accumulate -> f32 rescale. ``rescale``
    is a scalar (per-tensor) or a [N] vector (per-output-channel)."""
    r = np.asarray(rescale, np.float32)
    cache: dict = {}

    def fn(xq, wq, _r=r):
        K = wq.shape[0]
        # flatten leading dims so trailing dims multiply to K
        # (covers fc's num_flatten_dims without its closure)
        split, prod = xq.dim(), 1
        while split > 0 and prod < K:
            split -= 1
            prod *= xq.shape[split]
        enforce(prod == K,
                "int8 mul: input shape %s incompatible with "
                "weight K=%d" % (tuple(xq.shape), K))
        lead = tuple(xq.shape[:split])
        y32 = int8_matmul(torch.reshape(xq, (-1, K)), wq)
        # int32 * f32 computes in f32: the sums converted (round to
        # nearest) and multiplied in one pass, as y32.astype(f32) * r
        y = y32 * _device_vector(cache, _r, y32)
        return torch.reshape(y, (*lead, wq.shape[1]))

    return fn


def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor, strides, paddings,
                dilations) -> torch.Tensor:
    """An int8 NCHW convolution against int8 OIHW weights (groups 1),
    accumulated exactly in int32: the input windows gathered from the
    zero-padded codes (im2col, one strided view per kernel tap) and
    contracted with the filters by :func:`int8_matmul`."""
    N, C, H, W = xq.shape
    O, _, kh, kw = wq.shape
    sh, sw = strides
    ph, pw = paddings
    dh, dw = dilations
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    xp = F.pad(xq, (pw, pw, ph, ph)) if ph or pw else xq
    taps = [xp[:, :, i * dh:i * dh + sh * (Ho - 1) + 1:sh,
               j * dw:j * dw + sw * (Wo - 1) + 1:sw]
            for i in range(kh) for j in range(kw)]
    # [N, Ho, Wo, C, kh * kw] -> rows of C * kh * kw (the filter's
    # OIHW order: channel-major, then the taps)
    cols = torch.stack(taps, dim=-1).permute(0, 2, 3, 1, 4).reshape(
        N * Ho * Wo, C * kh * kw)
    y = int8_matmul(cols, wq.reshape(O, -1).t())
    return y.reshape(N, Ho, Wo, O).permute(0, 3, 1, 2)


def _int8_conv_fn(rescale, strides, paddings, dilations, groups):
    """int8 NCHW conv against int8 OIHW weights, int32 accumulation
    (:func:`int8_conv2d`), one f32 rescale per output channel."""
    enforce(int(groups) == 1, "int8 conv: grouped convolution is not "
            "quantized (per-channel scales do not factor)")
    r = np.asarray(rescale, np.float32).reshape(1, -1, 1, 1)
    strides = tuple(strides)
    paddings = tuple(paddings)
    dilations = tuple(dilations)
    cache: dict = {}

    def fn(xq, wq, _r=r):
        y32 = int8_conv2d(xq, wq, strides, paddings, dilations)
        return y32 * _device_vector(cache, _r, y32)

    return fn


# ---------------------------------------------------------------------------
# PTQ: calibration
# ---------------------------------------------------------------------------


class CalibrationResult:
    """Per-activation scales from one calibration sweep. ``digest()`` is
    composed into the quantize pass's fingerprint, so two programs
    quantized under different calibration data can never resolve each
    other's compile-cache entries."""

    def __init__(self, scales: Dict[str, float], method: str = "absmax",
                 bit_length: int = 8):
        self.scales = {str(k): float(v) for k, v in scales.items()}
        self.method = str(method)
        self.bit_length = int(bit_length)

    def digest(self) -> str:
        text = "|".join(
            [self.method, str(self.bit_length)]
            + [f"{n}={self.scales[n]!r}" for n in sorted(self.scales)])
        return hashlib.sha256(text.encode()).hexdigest()[:16]

    def __repr__(self):
        return (f"CalibrationResult({len(self.scales)} activations, "
                f"method={self.method!r}, digest={self.digest()})")


def _matmul_closure_ok(op) -> bool:
    """layers.matmul bakes transpose_x/transpose_y/alpha into the fn's
    closure, not attrs — only the plain X @ W form maps onto the int8
    product, so anything else (or an uninspectable fn) is skipped."""
    fn = op.fn
    code = getattr(fn, "__code__", None)
    if code is None:
        return False
    cells = dict(zip(code.co_freevars, fn.__closure__ or ()))
    try:
        tx = cells["transpose_x"].cell_contents
        ty = cells["transpose_y"].cell_contents
        alpha = cells["alpha"].cell_contents
    except (KeyError, ValueError):
        return False
    return not tx and not ty and alpha == 1.0


def _is_float(dtype) -> bool:
    return dtype is torch.bfloat16 or (
        isinstance(dtype, np.dtype) and np.issubdtype(dtype, np.floating))


def _match_int8_target(block: Block, op: Operator, scope: Optional[Scope],
                       op_types: Sequence[str], policy
                       ) -> Optional[Tuple[str, str, int, str]]:
    """(activation, weight, channel_axis, kind) when ``op`` is
    quantizable: a target-family op whose weight operand is a
    persistable float tensor (materialized in ``scope`` when given) and
    whose type is not deny-listed by the AMP policy's f32 set."""
    if op.fn is None or op.type not in op_types:
        return None
    if policy is not None and op.type in policy.deny:
        return None
    if op.type in ("mul", "matmul"):
        if len(op.input_arg_names) != 2:
            return None
        x_name, w_name = op.input_arg_names[0], op.input_arg_names[1]
        axis, kind = 1, "mul"
        if op.type == "matmul" and not _matmul_closure_ok(op):
            return None
    elif op.type == "conv2d":
        x_name = op.input("Input")[0]
        w_name = op.input("Filter")[0]
        axis, kind = 0, "conv"
        if int(op.attrs.get("groups", 1)) != 1:
            return None  # grouped conv: per-channel scales don't factor
    else:
        return None
    wv = block._find_var_recursive(w_name)
    xv = block._find_var_recursive(x_name)
    if wv is None or not wv.persistable or xv is None:
        return None
    if not (_is_float(wv.dtype) and _is_float(xv.dtype)):
        return None
    if op.type in ("mul", "matmul") and (
            wv.shape is None or len(wv.shape) != 2):
        return None
    if scope is not None and not scope.has_var(w_name):
        return None
    return x_name, w_name, axis, kind


def quantizable_activations(program: Program,
                            op_types: Sequence[str] = DEFAULT_INT8_OP_TYPES,
                            policy=None,
                            scope: Optional[Scope] = None) -> List[str]:
    """Ordered, de-duplicated activation names the PTQ rewrite would
    quantize — the fetch set :func:`calibrate_program` observes."""
    names: List[str] = []
    for block in program.blocks:
        for op in block.ops:
            t = _match_int8_target(block, op, scope, op_types, policy)
            if t is not None and t[0] not in names:
                names.append(t[0])
    return names


def calibrate_program(program: Program, feeds: Sequence[Dict],
                      scope: Optional[Scope] = None, place=None,
                      method: str = "absmax", momentum: float = 0.9,
                      op_types: Sequence[str] = DEFAULT_INT8_OP_TYPES,
                      policy=None, bit_length: int = 8
                      ) -> CalibrationResult:
    """Observe per-activation absmax over a representative feed set.

    Runs the (still-f32) ``program`` once per feed dict on ``place``
    (default: the card), fetching every quantizable activation.
    ``method="absmax"`` keeps the max over all batches (the QAT range
    window collapsed to its max — robust default);
    ``method="moving_average"`` keeps an EMA with ``momentum`` (smooths
    a long calibration stream with outlier batches)."""
    enforce(method in ("absmax", "moving_average"),
            "calibration method must be 'absmax' or 'moving_average', "
            "got %r" % (method,))
    enforce(feeds, "calibrate_program needs at least one feed batch")
    from ..executor import Executor

    scope = scope or global_scope()
    names = quantizable_activations(program, op_types=op_types,
                                    policy=policy, scope=scope)
    enforce(names, "calibrate_program: no quantizable activations found "
            "(op families %s with persistable float weights)"
            % (tuple(op_types),))
    exe = Executor(place)
    scales: Dict[str, float] = {}
    for feed in feeds:
        vals = exe.run(program, feed=feed, fetch_list=list(names),
                       scope=scope)
        for n, v in zip(names, vals):
            cur = float(np.max(np.abs(np.asarray(v, np.float32))))
            if method == "absmax":
                scales[n] = max(scales.get(n, 0.0), cur)
            else:
                scales[n] = (cur if n not in scales
                             else momentum * scales[n]
                             + (1.0 - momentum) * cur)
    return CalibrationResult(
        {n: max(s, 1e-8) for n, s in scales.items()},
        method=method, bit_length=bit_length)


# ---------------------------------------------------------------------------
# PTQ: the rewrite pass
# ---------------------------------------------------------------------------


@register_pass("ptq_int8")
class QuantizePass(Pass):
    """Post-training int8 quantization for serving (module docstring).

    Returns a rewritten ``clone(for_test=True)``: each calibrated
    ``mul``/``matmul``/``conv2d`` becomes ``quantize_act`` (one per
    activation per block, CSE'd) feeding ``int8_mul_dequant`` /
    ``int8_conv_dequant`` against an int8 weight stored in the scope
    under ``<name>@INT8`` with per-channel scales; the op's f32 output
    var is unchanged, so deny-listed consumers (softmax/norms/losses/
    lookup) see exactly the f32 stream the AMP policy promises them.
    Ops without a calibrated scale are left f32 (counted in
    ``program._int8_skipped``). Run through the PassManager
    (:func:`quantize_for_serving`) for the self-lint + stamp."""

    mutates_scope = True
    reads = frozenset(DEFAULT_INT8_OP_TYPES)
    writes = frozenset({"quantize_act", "int8_mul_dequant",
                        "int8_conv_dequant"})

    def __init__(self, calibration: CalibrationResult,
                 bit_length: int = 8, per_channel: bool = True,
                 op_types: Sequence[str] = DEFAULT_INT8_OP_TYPES,
                 policy=None):
        enforce(isinstance(calibration, CalibrationResult),
                "QuantizePass needs a CalibrationResult "
                "(calibrate_program)")
        self.calibration = calibration
        self.bit_length = int(bit_length)
        self.per_channel = bool(per_channel)
        self.op_types = tuple(op_types)
        self.policy = policy

    def fingerprint(self) -> str:
        policy_fp = (self.policy.fingerprint()
                     if self.policy is not None else "default")
        return "int8/b%d/%s/%s/ops:%s/policy:%s" % (
            self.bit_length,
            "per_channel" if self.per_channel else "per_tensor",
            self.calibration.digest(), ",".join(sorted(self.op_types)),
            policy_fp)

    # ------------------------------------------------------------------
    def _weight_int8(self, block: Block, scope: Scope, w_name: str,
                     axis: int):
        """Store ``<w_name>@INT8`` (idempotent per program) and return
        (int8 name, per-channel weight scale vector). Cached per
        (weight, axis) for the duration of one apply() — a shared
        weight (tied embeddings) feeding N ops quantizes once, not N
        times. The weight is quantized on the host in numpy; the int8
        weight goes back to the device the f32 one lies on."""
        cached = self._weight_cache.get((w_name, axis))
        if cached is not None:
            return cached
        B = _bound(self.bit_length)
        w_val = scope.get(w_name)
        w = _host_f32(w_val)
        if self.per_channel:
            reduce_axes = tuple(i for i in range(w.ndim) if i != axis)
            sw = np.maximum(np.max(np.abs(w), axis=reduce_axes), 1e-8)
            shape = [1] * w.ndim
            shape[axis] = -1
            w8 = np.clip(np.round(w / sw.reshape(shape) * B), -B, B) \
                .astype(np.int8)
        else:
            sw = np.maximum(np.max(np.abs(w)), 1e-8)
            w8 = np.clip(np.round(w / sw * B), -B, B).astype(np.int8)
        w8_name = w_name + "@INT8"
        if block._find_var_recursive(w8_name) is None:
            block.create_var(name=w8_name, shape=list(w8.shape),
                             dtype="int8", persistable=True)
        _store(scope, w8_name, w8, w_val)
        self._weight_cache[(w_name, axis)] = (w8_name, sw)
        return w8_name, sw

    def _rewrite_block(self, program: Program, block: Block,
                       scope: Scope) -> Tuple[int, int]:
        B = _bound(self.bit_length)
        quant_cache: Dict[str, str] = {}  # activation -> int8 code var
        n_quantized = n_skipped = 0
        i = 0
        while i < len(block.ops):
            op = block.ops[i]
            target = _match_int8_target(block, op, scope, self.op_types,
                                        self.policy)
            if target is None:
                # a redefinition of a quantized activation invalidates
                # its cached int8 codes (the amp rewrite's idiom)
                for n in op.output_arg_names:
                    quant_cache.pop(n, None)
                i += 1
                continue
            x_name, w_name, axis, kind = target
            sx = self.calibration.scales.get(x_name)
            if sx is None:
                n_skipped += 1
                for n in op.output_arg_names:
                    quant_cache.pop(n, None)
                i += 1
                continue
            w8_name, sw = self._weight_int8(block, scope, w_name, axis)
            x8_name = quant_cache.get(x_name)
            if x8_name is None:
                xv = block._find_var_recursive(x_name)
                x8_name = unique_name.generate(x_name + "@int8")
                block.create_var(
                    name=x8_name,
                    shape=None if xv is None else xv.shape,
                    dtype="int8")
                qop = Operator(
                    block, "quantize_act", inputs={"X": [x_name]},
                    outputs={"Out": [x8_name]},
                    attrs={"scale": float(sx),
                           "bit_length": self.bit_length},
                    fn=_quant_act_fn(sx, B))
                block.ops.insert(i, qop)
                v = block._find_var_recursive(x8_name)
                if v is not None and v.op is None:
                    v.op = qop
                quant_cache[x_name] = x8_name
                i += 1
            rescale = np.asarray(sx, np.float32) * np.asarray(
                sw, np.float32) / np.float32(B * B)
            out_name = op.output_arg_names[0]
            if kind == "conv":
                attrs = {"rescale_digest": _digest_array(rescale),
                         "bit_length": self.bit_length,
                         "strides": op.attrs.get("strides", (1, 1)),
                         "paddings": op.attrs.get("paddings", (0, 0)),
                         "dilations": op.attrs.get("dilations", (1, 1))}
                fn = _int8_conv_fn(rescale,
                                   attrs["strides"], attrs["paddings"],
                                   attrs["dilations"],
                                   int(op.attrs.get("groups", 1)))
                new_type = "int8_conv_dequant"
            else:
                attrs = {"rescale_digest": _digest_array(rescale),
                         "bit_length": self.bit_length}
                fn = _int8_mul_fn(rescale)
                new_type = "int8_mul_dequant"
            nop = Operator(block, new_type,
                           inputs={"X": [x8_name], "Y": [w8_name]},
                           outputs={"Out": [out_name]}, attrs=attrs,
                           fn=fn)
            block.ops[i] = nop
            # this op REDEFINES its outputs too: cached int8 codes of
            # the old value are stale
            for n in op.output_arg_names:
                quant_cache.pop(n, None)
            ov = block._find_var_recursive(out_name)
            if ov is not None:
                ov.op = nop
            program._bump()
            n_quantized += 1
            i += 1
        return n_quantized, n_skipped

    def apply(self, program: Program, scope=None) -> Program:
        scope = scope or global_scope()
        for b in program.blocks:
            for op in b.ops:
                enforce(op.type != "backward",
                        "ptq_int8 quantizes INFERENCE programs — prune/"
                        "clone the forward before quantizing")
        out = program.clone(for_test=True)
        self._weight_cache = {}
        n_quantized = n_skipped = 0
        for block in out.blocks:
            q, s = self._rewrite_block(out, block, scope)
            n_quantized += q
            n_skipped += s
        out._int8_quantized = n_quantized
        out._int8_skipped = n_skipped
        return out


def _digest_array(a: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(a)).tobytes()).hexdigest()[:16]


def quantize_for_serving(program: Program, scope: Optional[Scope],
                         calibration_feeds: Sequence[Dict],
                         bit_length: int = 8, per_channel: bool = True,
                         method: str = "absmax", momentum: float = 0.9,
                         op_types: Sequence[str] = DEFAULT_INT8_OP_TYPES,
                         policy=None, place=None,
                         check: bool = True) -> Program:
    """One call: calibrate on ``calibration_feeds`` (on ``place``,
    default the card) then quantize through the
    :class:`~paddle_tpu_torch.passes.PassManager` — the result
    self-lints to zero diagnostics, carries ``_passes_stamp`` (a key of
    the compile cache's exports), and serves straight through
    ``serving.BucketedEngine.from_program`` / ``save_inference_model``.
    The calibration is attached as ``program._ptq_calibration``."""
    from .manager import PassManager

    scope = scope or global_scope()
    calib = calibrate_program(
        program, calibration_feeds, scope=scope, place=place,
        method=method, momentum=momentum, op_types=op_types,
        policy=policy, bit_length=bit_length)
    pm = PassManager([QuantizePass(calib, bit_length=bit_length,
                                   per_channel=per_channel,
                                   op_types=op_types, policy=policy)],
                     check=check, stamp=True)
    out = pm.apply(program, scope=scope)
    out._ptq_calibration = calib
    return out
