"""Static per-op FLOP/byte cost attribution over the Program IR
(counterpart of paddle_tpu/obs/cost.py, the same families, formulas and
totals).

This module computes an MFU numerator from the program itself: one
walk over the ops, shapes propagated through the
``analysis.op_registry`` signature lattice (plus abstract evaluation
of the op's torch fn on meta tensors), and a per-op-family cost model
— matmul, conv, attention, elementwise, reduction, data movement. The counts are STATIC: provable on CPU,
identical on any device, and exact for the families that dominate MFU
(a matmul's FLOPs are its shape, not a measurement).

Honesty rules (the op-registry lattice discipline): an op with no cost
rule, or whose shapes stay symbolic, degrades to **unknown** — it is
listed in the report, never silently folded into a fake number. The
fused ``backward`` op uses the standard autodiff cost model (backward
of a matmul is exactly two matmuls): 2x the known forward cost, and it
inherits the forward walk's unknowns.

Joined with measured step times or profiler span totals
(``achieved``/``roofline``), this gives MFU *inputs*: the caller brings
the card's peak as the denominator, the numerator is not
hand-estimated.

Elementwise/reduction ops are counted at 1 FLOP per output/input
element (a nominal convention — they are bandwidth-, not FLOP-bound;
the bytes column is the number that matters for them).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..analysis.infer import _infer_op, declared_type
from ..core import dtype_utils
from ..analysis.op_registry import (SignatureError, TensorType, UNKNOWN,
                                    shapes_compatible, meet)

# ---------------------------------------------------------------------------
# Closed-form family formulas — shared by the Program walker and the
# scripts that measure raw kernels (no Program to walk).
# ---------------------------------------------------------------------------


def matmul_flops(m: float, k: float, n: float, batch: float = 1.0) -> float:
    """2 FLOPs per MAC over an [m, k] x [k, n] product, ``batch`` times."""
    return 2.0 * batch * m * k * n


def conv2d_flops(out_shape: Sequence[int], in_channels_per_group: int,
                 kh: int, kw: int) -> float:
    """2 FLOPs per MAC per output element of a (grouped) conv."""
    return 2.0 * float(np.prod(out_shape)) * in_channels_per_group * kh * kw


def attention_flops(batch: float, heads: float, q_len: float,
                    kv_len: float, head_dim: float,
                    head_dim_v: Optional[float] = None,
                    causal: bool = False, train: bool = False) -> float:
    """Scaled-dot-product attention matmul FLOPs: QK^T scores plus the
    probs x V weighted sum. ``train=True`` applies the 3.5x fwd-matmul
    convention (2 fwd matmuls + 5 bwd/recompute passes); ``causal``
    halves (the masked tiles are skipped)."""
    dv = head_dim if head_dim_v is None else head_dim_v
    total = (2.0 * batch * heads * q_len * kv_len * head_dim
             + 2.0 * batch * heads * q_len * kv_len * dv)
    if train:
        # 2 fwd matmuls + 5 bwd/recompute passes = 3.5x the fwd cost
        total *= 3.5
    if causal:
        total /= 2.0
    return total


# ---------------------------------------------------------------------------
# Per-op cost rules.
# ---------------------------------------------------------------------------

# ops that move/index data without arithmetic: 0 FLOPs, bytes counted
_DATA_OPS = {
    "lookup_table", "token_lookup", "gather_last_token",
    "last_token_logits", "pos_encoding_at", "pos_encoding_from",
    "greedy_token", "greedy_tokens", "sample_token", "sample_tokens",
    "sharding_constraint", "reshape", "squeeze", "unsqueeze",
    "transpose", "concat", "split", "cast", "fill_constant",
    "quantize_act", "one_hot", "sequence_expand", "gather",
}

_REDUCE_OPS = {"mean", "reduce_sum", "reduce_mean", "reduce_max",
               "reduce_min", "reduce_prod"}

# elementwise-ish families: 1 FLOP per output element (nominal;
# bandwidth-bound in practice — read the bytes column)
_ELEMENTWISE_OPS = {
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "sum", "layer_norm", "batch_norm",
    "softmax_with_cross_entropy", "cross_entropy", "square_error_cost",
    "pool2d", "amp_scale_loss", "amp_cast_params",
    "amp_check_finite_and_unscale", "amp_update_loss_scaling",
}
# shape-preserving unary activations/math share the rule
from ..analysis.op_registry import _UNARY_SAME  # noqa: E402

_ELEMENTWISE_OPS |= set(_UNARY_SAME)


def _prod(shape) -> Optional[float]:
    """Element count, None while any extent is symbolic."""
    if shape is None or any(d < 0 for d in shape):
        return None
    out = 1.0
    for d in shape:
        out *= d
    return out


def _tensor_bytes(ts: Sequence[TensorType]) -> Optional[float]:
    """Summed bytes of the fully-known tensors (None when nothing is
    known — a partial sum over some operands is still honest traffic
    accounting and is flagged per-op via ``flops is None`` instead)."""
    total, known = 0.0, False
    for t in ts:
        n = _prod(t.shape)
        if n is None or t.dtype is None:
            continue
        total += n * dtype_utils.itemsize(t.dtype)
        known = True
    return total if known else None


class OpCost:
    """One op's attribution: family + FLOPs/bytes (None = unknown)."""

    __slots__ = ("op_type", "family", "flops", "bytes")

    def __init__(self, op_type: str, family: str,
                 flops: Optional[float], byts: Optional[float]):
        self.op_type = op_type
        self.family = family
        self.flops = flops
        self.bytes = byts

    def __repr__(self):
        return (f"OpCost({self.op_type}: {self.family}, "
                f"flops={self.flops}, bytes={self.bytes})")


def _dequant_bytes(op, ins: List[TensorType]) -> Optional[float]:
    """Extra f32 traffic of the int8-KV dequantize-on-gather: the
    decode/extend window gather materializes the gathered K/V window at
    the compute dtype after scaling (codes x per-slot scale) — traffic
    the int8 pool operands in ``_tensor_bytes`` cannot see (they are
    counted at 1 byte/element). Closed form = the FULL block-window
    upper bound, matching the FLOP count's window convention:
    ``B * slots * heads * head_dim * 4`` bytes per pool."""
    if op.type not in ("paged_attention_decode",
                       "paged_attention_extend"):
        return None
    if op.attrs.get("kv_dtype") != "int8":
        return None
    if len(ins) < 6:
        return None
    q, kc, vc, tables = ins[0], ins[3], ins[4], ins[5]
    if any(x.shape is None or any(d < 0 for d in x.shape)
           for x in (q, kc, vc, tables)) or len(kc.shape) != 4 \
            or len(vc.shape) != 4 or len(tables.shape) != 2:
        return None
    b = q.shape[0]
    slots = tables.shape[1] * kc.shape[1]        # blocks x block_size
    per_slot = kc.shape[2] * kc.shape[3] + vc.shape[2] * vc.shape[3]
    return 4.0 * b * slots * per_slot


def _op_flops(op, ins: List[TensorType], outs: List[TensorType],
              fwd_known_flops: float) -> Tuple[str, Optional[float]]:
    """(family, flops) for one op; flops None = unknown, never faked."""
    t = op.type
    if t in ("mul", "int8_mul_dequant"):
        x = _prod(ins[0].shape) if ins else None
        w = ins[1].shape if len(ins) > 1 else None
        if x is None or w is None or len(w) != 2 or w[1] < 0:
            return "matmul", None
        return "matmul", 2.0 * x * w[1]
    if t == "matmul":
        out = _prod(outs[0].shape) if outs else None
        k = (ins[0].shape[-1] if ins and ins[0].shape else -1)
        if out is None or k < 0:
            return "matmul", None
        return "matmul", 2.0 * out * k
    if t == "fused_linear_softmax_ce":
        # inputs: X [.., d], W [d, V], Label, [Bias] — the chunked
        # projection is the matmul; softmax+CE ride as elementwise noise
        x = _prod(ins[0].shape) if ins else None
        w = ins[1].shape if len(ins) > 1 else None
        if x is None or w is None or len(w) != 2 or w[1] < 0:
            return "matmul", None
        return "matmul", 2.0 * x * w[1]
    if t in ("conv2d", "depthwise_conv2d", "int8_conv_dequant"):
        out = _prod(outs[0].shape) if outs else None
        w = ins[1].shape if len(ins) > 1 else None
        if out is None or w is None or len(w) != 4 \
                or any(d < 0 for d in w):
            return "conv", None
        return "conv", 2.0 * out * w[1] * w[2] * w[3]
    if t == "fused_attention":
        if len(ins) < 3 or any(x.shape is None or len(x.shape) != 3
                               or any(d < 0 for d in x.shape)
                               for x in ins[:3]):
            return "attention", None
        q, k, v = ins[0].shape, ins[1].shape, ins[2].shape
        b, tq, dq = q
        tk, dv = k[1], v[2]
        causal = bool(op.attrs.get("causal"))
        return "attention", attention_flops(b, 1, tq, tk, dq,
                                            head_dim_v=dv, causal=causal)
    if t in ("paged_attention_prefill", "paged_attention_decode",
             "paged_attention_extend"):
        # the static count is the FULL block-window upper bound: the
        # table geometry is the only shape the program carries (actual
        # per-step context lengths are runtime data)
        if len(ins) < 6:
            return "attention", None
        q, kc, vc, tables = ins[0], ins[3], ins[4], ins[5]
        if any(x.shape is None or any(d < 0 for d in x.shape)
               for x in (q, kc, vc, tables)) or len(q.shape) != 3 \
                or len(kc.shape) != 4 or len(tables.shape) != 2:
            return "attention", None
        b, tq, dq = q.shape
        tk = tables.shape[1] * kc.shape[1]
        dv = vc.shape[2] * vc.shape[3]
        return "attention", attention_flops(b, 1, tq, tk, dq,
                                            head_dim_v=dv)
    if t == "backward":
        # standard autodiff cost model: backward of every linear map is
        # two same-shaped products -> 2x the known forward cost; the
        # forward walk's unknown ops stay unknown (listed in the report)
        return "backward", (2.0 * fwd_known_flops
                            if fwd_known_flops > 0 else None)
    if t in _DATA_OPS:
        return "data", 0.0
    if t in _REDUCE_OPS:
        n = _prod(ins[0].shape) if ins else None
        return "reduction", n
    if t in _ELEMENTWISE_OPS:
        n = _prod(outs[0].shape) if outs else None
        return "elementwise", n
    return "unknown", None


class CostReport:
    """The walk result: per-op attributions with family rollups."""

    def __init__(self, ops: List[OpCost]):
        self.ops = ops

    @property
    def total_flops(self) -> float:
        """Sum of the ATTRIBUTED FLOPs (unknown ops contribute nothing
        — check ``unknown_op_types`` before trusting a tight bound)."""
        return sum(o.flops for o in self.ops if o.flops)

    @property
    def total_bytes(self) -> float:
        return sum(o.bytes for o in self.ops if o.bytes)

    def by_family(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for o in self.ops:
            fam = out.setdefault(o.family, {"ops": 0, "flops": 0.0,
                                            "bytes": 0.0, "unknown": 0})
            fam["ops"] += 1
            if o.flops is not None:
                fam["flops"] += o.flops
            else:
                fam["unknown"] += 1
            if o.bytes is not None:
                fam["bytes"] += o.bytes
        return out

    def unknown_op_types(self) -> List[str]:
        return sorted({o.op_type for o in self.ops if o.flops is None})

    @property
    def fully_attributed(self) -> bool:
        return not self.unknown_op_types()

    def render(self) -> str:
        lines = [f"{'family':<14}{'ops':>6}{'GFLOP':>12}{'MB':>12}"
                 f"{'unknown':>9}"]
        fams = self.by_family()
        for name in sorted(fams, key=lambda n: -fams[n]["flops"]):
            f = fams[name]
            lines.append(f"{name:<14}{f['ops']:>6}"
                         f"{f['flops'] / 1e9:>12.4f}"
                         f"{f['bytes'] / 1e6:>12.3f}{f['unknown']:>9}")
        lines.append(f"{'total':<14}{len(self.ops):>6}"
                     f"{self.total_flops / 1e9:>12.4f}"
                     f"{self.total_bytes / 1e6:>12.3f}"
                     f"{sum(1 for o in self.ops if o.flops is None):>9}")
        unk = self.unknown_op_types()
        if unk:
            lines.append("unattributed op types (degraded to unknown, "
                         "not faked): " + ", ".join(unk))
        return "\n".join(lines)


def report(program, feed_shapes: Optional[Dict[str, Sequence[int]]] = None,
           batch_size: Optional[int] = None) -> CostReport:
    """Walk ``program``'s global block and attribute per-op cost.

    ``feed_shapes`` binds concrete shapes to feed/data vars (name ->
    shape); ``batch_size`` is the shorthand that substitutes every ``-1``
    in the DATA vars' declared shapes. Unresolved symbolic dims degrade
    the affected ops to unknown — never to fabricated numbers.
    """
    block = program.global_block()
    env: Dict[str, TensorType] = {}
    feed_shapes = dict(feed_shapes or {})
    if batch_size is not None:
        for name, var in block.vars.items():
            if getattr(var, "is_data", False) and name not in feed_shapes \
                    and var.shape is not None:
                feed_shapes[name] = tuple(
                    batch_size if d == -1 else d for d in var.shape)
    for name, shape in feed_shapes.items():
        var = block.vars.get(name)
        env[name] = TensorType(shape,
                               var.dtype if var is not None else None)

    def lookup(n: str) -> TensorType:
        if n in env:
            return env[n]
        return declared_type(block._find_var_recursive(n))

    ops: List[OpCost] = []
    fwd_known = 0.0
    for op in block.ops:
        ins = [lookup(n) for n in op.input_arg_names]
        try:
            outs = _infer_op(op, ins)
        except SignatureError:
            outs = None
        if outs is None:
            outs = [UNKNOWN] * len(op.output_arg_names)
        out_types: List[TensorType] = []
        for name, inferred in zip(op.output_arg_names, outs):
            decl = declared_type(block._find_var_recursive(name))
            t = (meet(inferred, decl)
                 if shapes_compatible(inferred.shape, decl.shape)
                 and (inferred.dtype is None or decl.dtype is None
                      or inferred.dtype == decl.dtype)
                 else inferred)
            env[name] = t
            out_types.append(t)
        family, flops = _op_flops(op, ins, out_types, fwd_known)
        if flops is not None and family != "backward":
            fwd_known += flops
        byts = _tensor_bytes(ins + out_types)
        extra = _dequant_bytes(op, ins)
        if extra:
            byts = (byts or 0.0) + extra
        ops.append(OpCost(op.type, family, flops, byts))
    return CostReport(ops)


# ---------------------------------------------------------------------------
# Joining with span totals: achieved vs roofline.
# ---------------------------------------------------------------------------


def achieved(flops: Optional[float], seconds: float,
             peak_flops: Optional[float] = None) -> Dict[str, object]:
    """Achieved throughput from static FLOPs + measured seconds, with
    MFU when a peak is known (None otherwise — "not measured", never a
    fake 0.0)."""
    if not flops or not seconds or seconds <= 0:
        return {"flops": flops, "flops_per_sec": None, "mfu": None}
    fps = flops / seconds
    return {"flops": flops, "flops_per_sec": fps,
            "mfu": (fps / peak_flops) if peak_flops else None}


def roofline(cost_report: CostReport, span_totals: Dict[str, float],
             compute_span: str = "dispatch", steps: int = 1,
             peak_flops: Optional[float] = None,
             comm_report=None) -> Dict[str, object]:
    """Achieved-vs-roofline join: the report's static FLOPs/bytes per
    dispatch x ``steps``, over the measured ``compute_span`` total
    (seconds by span name, e.g. the profiler's ``dispatch`` spans).
    Returns per-family shares plus the achieved/MFU block.

    ``comm_report`` (an ``analysis.CommReport``) adds the predicted
    static collective volume beside the FLOP and byte columns, under
    the JAX package's key names (``static_ici_bytes_per_step``,
    ``comm_events``, ``comm_unknown_op_types``). Keys are ABSENT (not
    null) when no report is given."""
    seconds = float(span_totals.get(compute_span, 0.0))
    total = cost_report.total_flops * steps
    out: Dict[str, object] = {
        "compute_span": compute_span,
        "span_total_s": round(seconds, 6),
        "steps": steps,
        "static_flops_per_step": cost_report.total_flops,
        "static_bytes_per_step": cost_report.total_bytes,
        "unknown_op_types": cost_report.unknown_op_types(),
    }
    if comm_report is not None:
        out["static_ici_bytes_per_step"] = comm_report.total_bytes
        out["comm_events"] = comm_report.counts()
        out["comm_unknown_op_types"] = list(comm_report.unknowns)
    out.update(achieved(total, seconds, peak_flops))
    fams = cost_report.by_family()
    tot = cost_report.total_flops or 1.0
    out["family_flop_share"] = {
        name: round(f["flops"] / tot, 4)
        for name, f in sorted(fams.items()) if f["flops"]}
    return out
