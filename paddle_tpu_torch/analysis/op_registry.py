"""Op-signature registry: declarative per-op-type shape/dtype inference
(counterpart of paddle_tpu/analysis/op_registry.py, the same rules,
names and messages).

Reference: every Fluid op registers a C++ ``InferShape``/``InferVarType``
run over the ProgramDesc at build time (framework/shape_inference.h,
framework/op_registry.h REGISTER_OPERATOR). Here signatures are small
Python rules over an *unknown-dim lattice*:

  * a dim is an ``int >= 0`` (concrete), ``-1`` (dynamic/symbolic — the
    batch axis convention from layers.data), or part of an entirely
    unknown shape (``TensorType.shape is None``);
  * a dtype is a symbol-table dtype (a ``np.dtype``, or
    ``torch.bfloat16``, which numpy lacks: ``core/dtype_utils.py``) or
    ``None`` (unknown).

The lattice ordering is "unknown absorbs everything": rules must only
report a conflict when BOTH sides are concrete and disagree — unknown
ops/dims degrade to unknown values, never to false positives. Ops with
no registered signature fall back to abstract evaluation of their torch
fn on meta tensors in analysis/infer.py.

The communication half (``CommSig``, ``register_comm``) declares how
each op type moves sharded data; ``analysis/spmd.py`` reads it.

Adding a signature:

    @register_signature("my_op")
    def _sig_my_op(op, ins):
        # ins: List[TensorType]; return List[TensorType], one per output
        require(ins[0].rank in (None, 2), "expects a matrix input")
        return [TensorType(ins[0].shape, ins[0].dtype)]
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import dtype_utils


class SignatureError(Exception):
    """Raised by a signature rule when the op's inputs are inconsistent;
    carries the message the validator turns into a Diagnostic."""


def require(cond, message: str) -> None:
    if not cond:
        raise SignatureError(message)


def _dtype(dtype):
    """A symbol-table dtype, ``None`` (unknown) kept as it is."""
    return dtype_utils.normalize_dtype(dtype) if dtype is not None else None


class TensorType:
    """Abstract value on the shape/dtype lattice.

    ``shape is None``  — unknown rank (top of the shape lattice)
    ``dim == -1``      — dynamic extent (matches any concrete extent)
    ``dtype is None``  — unknown dtype
    """

    __slots__ = ("shape", "dtype")

    def __init__(self, shape: Optional[Sequence[int]] = None, dtype=None):
        self.shape = tuple(int(s) for s in shape) if shape is not None \
            else None
        self.dtype = _dtype(dtype)

    @property
    def rank(self) -> Optional[int]:
        return len(self.shape) if self.shape is not None else None

    @property
    def known(self) -> bool:
        return self.shape is not None

    def __repr__(self):
        d = dtype_utils.name(self.dtype) if self.dtype is not None else "?"
        return f"TensorType(shape={self.shape}, dtype={d})"


UNKNOWN = TensorType()  # top of the lattice: absorbs every meet


def dims_compatible(a: int, b: int) -> bool:
    """Lattice dim comparison: dynamic (-1) matches anything."""
    return a == -1 or b == -1 or a == b


def shapes_compatible(a: Optional[Tuple[int, ...]],
                      b: Optional[Tuple[int, ...]]) -> bool:
    """True unless both shapes are known AND provably conflict (rank or
    a pair of concrete dims)."""
    if a is None or b is None:
        return True
    if len(a) != len(b):
        return False
    return all(dims_compatible(x, y) for x, y in zip(a, b))


def meet_dim(a: int, b: int) -> int:
    """Meet of two compatible dims: concrete information wins."""
    return b if a == -1 else a


def meet(a: TensorType, b: TensorType) -> TensorType:
    """Lattice meet: combine two compatible abstract values, keeping the
    more concrete information from each side. Callers must check
    compatibility first (shapes_compatible / dtype equality)."""
    if a.shape is None:
        shape = b.shape
    elif b.shape is None:
        shape = a.shape
    else:
        shape = tuple(meet_dim(x, y) for x, y in zip(a.shape, b.shape))
    return TensorType(shape, a.dtype if a.dtype is not None else b.dtype)


def broadcast_shapes(a: Optional[Tuple[int, ...]],
                     b: Optional[Tuple[int, ...]]
                     ) -> Optional[Tuple[int, ...]]:
    """Numpy-style broadcast on the lattice; raises SignatureError on a
    provable conflict, returns None when either side is unknown."""
    if a is None or b is None:
        return None
    ra, rb = list(a), list(b)
    while len(ra) < len(rb):
        ra.insert(0, 1)
    while len(rb) < len(ra):
        rb.insert(0, 1)
    out = []
    for x, y in zip(ra, rb):
        if x == 1:
            out.append(y)
        elif y == 1:
            out.append(x)
        elif x == -1 or y == -1:
            out.append(meet_dim(x, y))
        elif x == y:
            out.append(x)
        else:
            raise SignatureError(
                f"operands cannot broadcast: {tuple(a)} vs {tuple(b)}")
    return tuple(out)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

# op type -> rule(op, ins: List[TensorType]) -> List[TensorType]
_SIGNATURES: Dict[str, Callable] = {}


def register_signature(*op_types: str) -> Callable:
    """Decorator registering one inference rule for op type(s)
    (reference: REGISTER_OPERATOR's InferShapeFn slot)."""

    def deco(fn):
        for t in op_types:
            _SIGNATURES[t] = fn
        return fn

    return deco


def get_signature(op_type: str) -> Optional[Callable]:
    return _SIGNATURES.get(op_type)


def registered_ops() -> List[str]:
    return sorted(_SIGNATURES)


# ---------------------------------------------------------------------------
# Built-in signatures for the core op families layers.py emits.
# ---------------------------------------------------------------------------

_UNARY_SAME = (
    # activations + shape-preserving unary math (layers/ops.py family)
    "relu", "sigmoid", "tanh", "exp", "softsign", "softplus", "relu6",
    "gelu", "logsigmoid", "tanh_shrink", "brelu", "leaky_relu", "elu",
    "hard_sigmoid", "swish", "softmax", "log_softmax", "sequence_softmax",
    "abs", "ceil", "floor", "round", "reciprocal", "square", "sqrt",
    "rsqrt", "log", "sin", "cos", "scale", "identity", "label_smooth",
    "l2_normalize", "clip", "dropout", "relu_grad", "assign", "snapshot",
    "increment",
)


@register_signature(*_UNARY_SAME)
def _sig_unary_same(op, ins):
    """Output mirrors the (single tensor) input's shape and dtype."""
    if not ins:
        return [UNKNOWN]
    return [TensorType(ins[0].shape, ins[0].dtype)]


def _axis_alignable(x: Tuple[int, ...], y: Tuple[int, ...]) -> bool:
    """Paddle's elementwise broadcast contract (elementwise_op.h): a
    lower-rank Y may align to ANY contiguous run of X's dims (the layer
    fns pick the axis in their closure, e.g. conv's channel-bias add
    reshaping Y to [1, C, 1, 1])."""
    if len(y) > len(x):
        return False
    for start in range(len(x) - len(y) + 1):
        if all(dims_compatible(xd, yd) or yd == 1
               for xd, yd in zip(x[start:start + len(y)], y)):
            return True
    return False


@register_signature("elementwise_add", "elementwise_sub",
                    "elementwise_mul", "elementwise_div",
                    "elementwise_max", "elementwise_min", "elementwise_pow")
def _sig_elementwise(op, ins):
    """Binary op under the reference's axis-aligned broadcast: numpy
    right-aligned broadcasting OR a lower-rank Y aligned to a contiguous
    run of X's dims (conv bias over the channel axis). Result dtype
    follows X when both sides agree; with MIXED float dtypes (a bf16
    activation meeting an f32 one under an AMP rewrite) the op families
    sharing these types disagree — fc's bias add casts Y to X's dtype
    while the generic layers.elementwise_* fns promote — so the rule
    defers to abstract evaluation of the actual fn, the only source
    that knows which arithmetic this op instance performs."""
    if len(ins) < 2:
        return [ins[0] if ins else UNKNOWN]
    if (ins[0].dtype is not None and ins[1].dtype is not None
            and ins[0].dtype != ins[1].dtype):
        return None  # mixed dtypes: let eval_shape of the fn decide
    x, y = ins[0].shape, ins[1].shape
    try:
        shape = broadcast_shapes(x, y)
    except SignatureError:
        if x is not None and y is not None and _axis_alignable(x, y):
            shape = x  # Y folds into X's extents
        else:
            raise SignatureError(
                "elementwise operands can neither broadcast nor "
                f"axis-align: {x} vs {y}")
    return [TensorType(shape, ins[0].dtype)]


@register_signature("sum")
def _sig_sum(op, ins):
    """N-ary add: all inputs must be mutually broadcastable. Mixed
    float dtypes defer to the fn (same promotion caveat as
    _sig_elementwise)."""
    dtypes = {t.dtype for t in ins if t.dtype is not None}
    if len(dtypes) > 1:
        return None
    shape = ins[0].shape if ins else None
    for t in ins[1:]:
        shape = broadcast_shapes(shape, t.shape)
    return [TensorType(shape, ins[0].dtype if ins else None)]


@register_signature("matmul")
def _sig_matmul(op, ins):
    """Batched matmul contract: last dim of X vs second-to-last of Y
    (the rule InferShape enforces for matmul_op.cc)."""
    if len(ins) < 2 or ins[0].shape is None or ins[1].shape is None:
        return [UNKNOWN]
    a, b = ins[0].shape, ins[1].shape
    if len(a) < 1 or len(b) < 1:
        return [UNKNOWN]
    k_a = a[-1]
    k_b = b[-2] if len(b) >= 2 else b[-1]
    require(dims_compatible(k_a, k_b),
            f"matmul contraction mismatch: X{a} @ Y{b} "
            f"(inner dims {k_a} vs {k_b})")
    if len(a) == 1 or len(b) == 1:
        return [TensorType(None, ins[0].dtype)]  # vector cases: punt
    lead = a[:-2] if len(a) >= len(b) else b[:-2]
    return [TensorType(tuple(lead) + (a[-2], b[-1]), ins[0].dtype)]


@register_signature("mean")
def _sig_mean(op, ins):
    """Full reduction to a scalar (layers/nn.py mean)."""
    dtype = ins[0].dtype if ins else None
    return [TensorType((), dtype)]


@register_signature("transpose")
def _sig_transpose(op, ins):
    perm = op.attrs.get("perm")
    if not ins or ins[0].shape is None or perm is None:
        return [TensorType(None, ins[0].dtype if ins else None)]
    shape = ins[0].shape
    require(sorted(perm) == list(range(len(shape))),
            f"perm {list(perm)} is not a permutation of rank {len(shape)}")
    return [TensorType(tuple(shape[p] for p in perm), ins[0].dtype)]


@register_signature("cast")
def _sig_cast(op, ins):
    dtype = op.attrs.get("dtype")
    return [TensorType(ins[0].shape if ins else None, dtype)]


@register_signature("fill_constant")
def _sig_fill_constant(op, ins):
    shape = op.attrs.get("shape")
    dtype = op.attrs.get("dtype")
    return [TensorType(tuple(shape) if shape is not None else None,
                       dtype)]


@register_signature("square_error_cost")
def _sig_square_error_cost(op, ins):
    if len(ins) >= 2:
        require(shapes_compatible(ins[0].shape, ins[1].shape),
                f"input {ins[0].shape} vs label {ins[1].shape} "
                "must match elementwise")
    return [TensorType(ins[0].shape if ins else None,
                       ins[0].dtype if ins else None)]


@register_signature("mul")
def _sig_mul(op, ins):
    """fc's projection: X flattened to 2-D against W[in, out]. The
    flatten split point (num_flatten_dims) is closed over by the fn, so
    the rule only handles the unambiguous 2-D case; higher ranks return
    None to defer to abstract evaluation of the fn itself."""
    if len(ins) < 2 or ins[0].shape is None or ins[1].shape is None:
        return None  # let eval_shape (or unknown degradation) decide
    w = ins[1].shape
    require(len(w) == 2, f"mul weight must be 2-D, got {w}")
    x = ins[0].shape
    if len(x) != 2:
        return None  # num_flatten_dims unknown: defer to the fn
    if x[1] != -1 and w[0] != -1:
        require(x[1] == w[0],
                f"mul contraction mismatch: X{x} against W{w}")
    if op.fn is not None:
        # the result dtype is the bf16 rule the fn closed over when the
        # layer was built (layers/nn.py _mm_rule: a bf16 product of f32
        # operands under the bf16 activation stream), which only the fn
        # knows: abstract evaluation decides. The JAX package's rule
        # takes X's dtype and so reports a false dtype-mismatch there
        # (ROADMAP Queue C).
        return None
    return [TensorType((x[0], w[1]), ins[0].dtype)]


@register_signature("concat")
def _sig_concat(op, ins):
    axis = op.attrs.get("axis")
    if axis is None or any(t.shape is None for t in ins) or not ins:
        return [TensorType(None, ins[0].dtype if ins else None)]
    rank = ins[0].rank
    require(all(t.rank == rank for t in ins),
            f"concat inputs must share rank, got "
            f"{[t.shape for t in ins]}")
    axis = axis % rank if rank else 0
    out = []
    for d in range(rank):
        if d == axis:
            dims = [t.shape[d] for t in ins]
            out.append(-1 if any(s == -1 for s in dims) else sum(dims))
        else:
            dims = [t.shape[d] for t in ins]
            first = dims[0]
            for s in dims[1:]:
                require(dims_compatible(first, s),
                        f"concat non-axis dim {d} mismatch: "
                        f"{[t.shape for t in ins]}")
                first = meet_dim(first, s)
            out.append(first)
    return [TensorType(tuple(out), ins[0].dtype)]


@register_signature("cross_entropy")
def _sig_cross_entropy(op, ins):
    """Per-example loss: [..., C] -> [..., 1] (cross_entropy_op.cc).
    The fn forces f32 internally, so the result dtype stays unknown."""
    if not ins or ins[0].shape is None:
        return [UNKNOWN]
    x = ins[0].shape
    if len(x) >= 2:
        return [TensorType(tuple(x[:-1]) + (1,), None)]
    return [UNKNOWN]


@register_signature("amp_cast_params")
def _sig_amp_cast_params(op, ins):
    """Fused master-weight cast (amp/rewrite.py): one output per input
    parameter, shapes mirrored, dtype pinned by the op's ``dtype`` attr
    (bf16 working copies of the f32 masters)."""
    dt = _dtype(op.attrs.get("dtype", "bfloat16"))
    return [TensorType(t.shape, dt) for t in ins]


@register_signature("amp_scale_loss")
def _sig_amp_scale_loss(op, ins):
    """loss * loss_scaling: result mirrors the loss operand (the fn
    casts the scale to the loss dtype, so no promotion happens)."""
    if len(ins) >= 2:
        require(ins[1].rank in (None, 0),
                "loss scaling must be a scalar")
    return [TensorType(ins[0].shape if ins else None,
                       ins[0].dtype if ins else None)]


@register_signature("amp_check_finite_and_unscale")
def _sig_amp_check_finite_and_unscale(op, ins):
    """(grads..., scale) -> (unscaled grads..., found_inf, ok): gradient
    slots pass through unchanged on the lattice; the two flags are
    scalar bools (the device-side overflow reduction)."""
    grads = ins[:-1] if ins else []
    flag = TensorType((), np.dtype(bool))
    return [TensorType(t.shape, t.dtype) for t in grads] + [flag, flag]


@register_signature("amp_update_loss_scaling")
def _sig_amp_update_loss_scaling(op, ins):
    """(scale, good, bad, found_inf) -> (scale, good, bad): the
    grow/backoff rule is shape/dtype-preserving on its state scalars."""
    return [TensorType(t.shape, t.dtype) for t in ins[:3]]


@register_signature("sharding_constraint")
def _sig_sharding_constraint(op, ins):
    """with_sharding_constraint injected by sharding.shard_program:
    identity on the value lattice (layout annotation only) — the output
    mirrors its input exactly, so sharded programs self-lint clean."""
    if not ins:
        return [UNKNOWN]
    return [TensorType(ins[0].shape, ins[0].dtype)]


@register_signature("lookup_table")
def _sig_lookup_table(op, ins):
    """ids [...,] x table [V, D] -> [..., D] (embedding gather)."""
    if len(ins) < 2 or ins[0].shape is None or ins[1].shape is None:
        return [UNKNOWN]
    ids, table = ins[0].shape, ins[1].shape
    require(len(table) == 2, f"embedding table must be 2-D, got {table}")
    lead = ids[:-1] if ids and ids[-1] == 1 else ids
    return [TensorType(tuple(lead) + (table[1],), ins[1].dtype)]


# -- decoding op family (paddle_tpu.decoding rewrite.py) --------------------
#
# The paged prefill/decode attention ops carry the persistable KV pools
# as BOTH input and output (in-place state update through the executor's
# written-persistables thread); their signatures pass the pool types
# through unchanged and derive the context from Q x VCache, so derived
# prefill/decode programs self-lint to zero diagnostics.


@register_signature("paged_attention_prefill", "paged_attention_decode",
                    "paged_attention_extend")
def _sig_paged_attention(op, ins):
    """[Q, K, V, KCache, VCache, BlockTables, SeqLens|Positions
    (|CachedLens + SeqLens for extend)(, KScale, VScale under int8)] ->
    (ctx [B, Tq, H*Dv], KCache, VCache(, KScale, VScale))."""
    q8 = op.attrs.get("kv_dtype") == "int8"
    base = 8 if op.type == "paged_attention_extend" else 7
    want = base + (2 if q8 else 0)
    n_out = 5 if q8 else 3
    if len(ins) < want:
        return [UNKNOWN] * n_out
    q, k, v, kc, vc = ins[0], ins[1], ins[2], ins[3], ins[4]
    for name, stream, pool in (("K", k, kc), ("V", v, vc)):
        if q8:
            if pool.dtype is not None:
                require(pool.dtype == np.dtype("int8"),
                        f"{name} pool dtype {pool.dtype} but the op "
                        "declares kv_dtype=int8 — pool created before "
                        "the int8-KV rewrite?")
        elif stream.dtype is not None and pool.dtype is not None:
            require(stream.dtype == pool.dtype,
                    f"{name} stream dtype {stream.dtype} != its KV pool "
                    f"dtype {pool.dtype} — pools are created with the "
                    "stream dtype; was the program re-cast after the "
                    "decode rewrite?")
    if kc.shape is not None:
        require(len(kc.shape) == 4,
                f"KCache pool must be 4-D [blocks, block, H, D], got "
                f"{kc.shape}")
    out = UNKNOWN
    if q.shape is not None and len(q.shape) == 3:
        dv = -1
        if vc.shape is not None and len(vc.shape) == 4 \
                and all(s >= 0 for s in vc.shape[2:]):
            dv = vc.shape[2] * vc.shape[3]
        elif v.shape is not None and len(v.shape) == 3:
            dv = v.shape[-1]
        out = TensorType((q.shape[0], q.shape[1], dv), q.dtype)
    outs = [out, TensorType(kc.shape, kc.dtype),
            TensorType(vc.shape, vc.dtype)]
    if q8:
        ks, vs = ins[want - 2], ins[want - 1]
        for name, sc in (("KScale", ks), ("VScale", vs)):
            if sc.shape is not None:
                require(len(sc.shape) == 2,
                        f"{name} pool must be 2-D [blocks, block], got "
                        f"{sc.shape}")
        outs += [TensorType(ks.shape, ks.dtype),
                 TensorType(vs.shape, vs.dtype)]
    return outs


@register_signature("pos_encoding_at", "pos_encoding_from")
def _sig_pos_encoding_at(op, ins):
    """x [B, T, D] + positions/cached_lens [B] -> x (additive
    encoding at absolute positions)."""
    if not ins:
        return [UNKNOWN]
    return [TensorType(ins[0].shape, ins[0].dtype)]


@register_signature("gather_last_token")
def _sig_gather_last_token(op, ins):
    """logits [B, T, V] + seq_lens [B] -> [B, V]."""
    if not ins or ins[0].shape is None:
        return [UNKNOWN]
    require(len(ins[0].shape) == 3,
            f"gather_last_token expects [B, T, V] logits, got "
            f"{ins[0].shape}")
    b, _, vocab = ins[0].shape
    return [TensorType((b, vocab), ins[0].dtype)]


@register_signature("last_token_logits")
def _sig_last_token_logits(op, ins):
    """logits [B, T, V] -> [B, V]."""
    if not ins or ins[0].shape is None:
        return [UNKNOWN]
    require(len(ins[0].shape) == 3,
            f"last_token_logits expects [B, T, V] logits, got "
            f"{ins[0].shape}")
    b, _, vocab = ins[0].shape
    return [TensorType((b, vocab), ins[0].dtype)]


@register_signature("greedy_token")
def _sig_greedy_token(op, ins):
    """next-token logits [B, V] -> token ids [B] (int32 argmax)."""
    if not ins or ins[0].shape is None:
        return [UNKNOWN]
    require(len(ins[0].shape) == 2,
            f"greedy_token expects [B, V] logits, got {ins[0].shape}")
    return [TensorType((ins[0].shape[0],), np.int32)]


@register_signature("greedy_tokens")
def _sig_greedy_tokens(op, ins):
    """window logits [B, T, V] -> token ids [B, T] (int32 argmax per
    position — the extend program's speculative-verify head)."""
    if not ins or ins[0].shape is None:
        return [UNKNOWN]
    require(len(ins[0].shape) == 3,
            f"greedy_tokens expects [B, T, V] logits, got "
            f"{ins[0].shape}")
    return [TensorType(ins[0].shape[:2], np.int32)]


@register_signature("sample_token")
def _sig_sample_token(op, ins):
    """next-token logits [B, V] + five [B] sampling feeds -> token ids
    [B] (seeded temperature/top-k/top-p, decoding/sampling.py)."""
    if not ins or ins[0].shape is None:
        return [UNKNOWN]
    require(len(ins[0].shape) == 2,
            f"sample_token expects [B, V] logits, got {ins[0].shape}")
    return [TensorType((ins[0].shape[0],), np.int32)]


@register_signature("sample_tokens")
def _sig_sample_tokens(op, ins):
    """window logits [B, T, V] + five [B] sampling feeds -> token ids
    [B, T] (position t samples stream index steps[b] + t)."""
    if not ins or ins[0].shape is None:
        return [UNKNOWN]
    require(len(ins[0].shape) == 3,
            f"sample_tokens expects [B, T, V] logits, got "
            f"{ins[0].shape}")
    return [TensorType(ins[0].shape[:2], np.int32)]


@register_signature("token_lookup")
def _sig_token_lookup(op, ins):
    """Decode-side embedding gather (NO trailing-1 squeeze):
    ids [B, T] x table [V, D] -> [B, T, D]."""
    if len(ins) < 2 or ins[0].shape is None or ins[1].shape is None:
        return [UNKNOWN]
    table = ins[1].shape
    require(len(table) == 2, f"embedding table must be 2-D, got {table}")
    return [TensorType(tuple(ins[0].shape) + (table[1],), ins[1].dtype)]


# The int8 quantization family (passes/quantize.py — QAT freeze and the
# ptq_int8 serving pass). Registered so quantized programs — including
# the STRUCTURAL manifest form the CLI rebuilds with fn=None — self-lint
# to zero diagnostics and the shape lattice flows through the int8 leg.


@register_signature("quantize_act")
def _sig_quantize_act(op, ins):
    """f32 activation -> int8 codes at one baked scale: same shape,
    dtype int8."""
    if not ins:
        return [UNKNOWN]
    return [TensorType(ins[0].shape, np.int8)]


@register_signature("int8_mul_dequant")
def _sig_int8_mul_dequant(op, ins):
    """int8 X [.., K] x int8 W [K, N] -> f32 [.., N] (int32 MAC + f32
    rescale; mirrors the mul contract with the leading dims flattened
    by the fn)."""
    if len(ins) < 2 or ins[0].shape is None or ins[1].shape is None:
        return [UNKNOWN]
    w = ins[1].shape
    require(len(w) == 2, f"int8 weight must be 2-D, got {w}")
    x = ins[0].shape
    if len(x) != 2:
        return None  # flatten split unknown: defer to the fn
    if x[1] != -1 and w[0] != -1:
        require(x[1] == w[0],
                f"int8 mul contraction mismatch: X{x} against W{w}")
    return [TensorType((x[0], w[1]), np.float32)]


@register_signature("int8_conv_dequant")
def _sig_int8_conv_dequant(op, ins):
    """int8 NCHW conv against int8 OIHW weights -> f32 NCHW (defers the
    spatial arithmetic to the fn when attrs are unavailable)."""
    if len(ins) < 2 or ins[0].shape is None or ins[1].shape is None:
        return [UNKNOWN]
    x, w = ins[0].shape, ins[1].shape
    require(len(x) == 4 and len(w) == 4,
            f"int8 conv expects NCHW x OIHW, got {x} x {w}")
    strides = op.attrs.get("strides")
    paddings = op.attrs.get("paddings")
    dilations = op.attrs.get("dilations", (1, 1))
    if strides is None or paddings is None:
        return None  # attrs unknown: defer to abstract evaluation
    def _dim(size, k, s, p, d):
        if size == -1 or k == -1:
            return -1
        eff = (k - 1) * d + 1
        return (size + 2 * p - eff) // s + 1
    h = _dim(x[2], w[2], strides[0], paddings[0], dilations[0])
    ww = _dim(x[3], w[3], strides[1], paddings[1], dilations[1])
    return [TensorType((x[0], w[0], h, ww), np.float32)]


# ---------------------------------------------------------------------------
# Comm-relevant metadata: how each op type moves sharded data. The SPMD
# spec propagator (analysis/spmd.py) reads these declarations —
# contraction dims, reduction axes, layout behavior — instead of
# special-casing op names; op types with no comm signature
# degrade to unknown-spec, never to a false prediction (the same
# lattice discipline as the shape signatures above).
# ---------------------------------------------------------------------------


class CommSig:
    """One op type's communication declaration.

    ``kind`` selects the propagation rule in analysis/spmd.py:

      elementwise     broadcast-merge input layouts (free: local slices)
      passthrough     every output mirrors input 0's layout
      mirror          output i mirrors input i (extra outputs scalar)
      contraction     dot-general: ``contract(op, ins)`` returns the
                      (lhs_dims, rhs_dims) contracting dims, or None to
                      degrade (e.g. a transposed operand the attrs
                      cannot see)
      reduction       ``reduce_dims(op, ins)`` returns the reduced dims
                      of input 0 (None degrades); sharded reduced dims
                      predict one all-reduce
      rowwise         normalizes over the LAST dim: passthrough iff
                      that dim is unsharded, else unknown (the sharded
                      softmax/layer_norm lowering is the partitioner's
                      business)
      transpose       permutes the layout by the ``perm`` attr
      constraint      sharding_constraint: output pinned to the cleaned
                      attr spec; dropped axes predict an all-gather
      replicated_out  produces a replicated value (fill_constant)
      attention       fused SDPA: passthrough iff Q/K/V share a
                      batch-only layout, else unknown
      gather_table    embedding gather: ids layout + a replicated
                      feature dim iff the table is unsharded
    """

    __slots__ = ("kind", "contract", "reduce_dims")

    def __init__(self, kind: str, contract: Optional[Callable] = None,
                 reduce_dims: Optional[Callable] = None):
        self.kind = kind
        self.contract = contract
        self.reduce_dims = reduce_dims

    def __repr__(self):
        return f"CommSig(kind={self.kind!r})"


_COMM_SIGNATURES: Dict[str, CommSig] = {}


def register_comm(*op_types: str, kind: str,
                  contract: Optional[Callable] = None,
                  reduce_dims: Optional[Callable] = None) -> None:
    """Declare comm-relevant metadata for op type(s) (the comm analog
    of :func:`register_signature`)."""
    sig = CommSig(kind, contract=contract, reduce_dims=reduce_dims)
    for t in op_types:
        _COMM_SIGNATURES[t] = sig


def get_comm_signature(op_type: str) -> Optional[CommSig]:
    return _COMM_SIGNATURES.get(op_type)


def comm_registered_ops() -> List[str]:
    return sorted(_COMM_SIGNATURES)


def _contract_matmul(op, ins):
    """matmul convention: last dim of X against second-to-last of Y.
    transpose_x/transpose_y are closed over by the fn (not attrs), so
    the assumed dims are VERIFIED against the concrete extents — a
    mismatch (a transposed operand) degrades to None, never to a wrong
    prediction."""
    if len(ins) < 2 or ins[0].shape is None or ins[1].shape is None:
        return None
    a, b = ins[0].shape, ins[1].shape
    if len(a) < 2 or len(b) < 2:
        return None
    if a[-1] != -1 and b[-2] != -1 and a[-1] != b[-2]:
        return None  # transposed operand: the declared dims would lie
    return ((len(a) - 1,), (len(b) - 2,))


def _contract_mul(op, ins):
    """mul/fc flattening contract: X's trailing dims against W[K, N].
    num_flatten_dims is closed over by the fn, so the split is
    re-derived from the shapes: the unique suffix of X whose product
    equals K. Ambiguity (symbolic dims, no exact suffix) returns None."""
    if len(ins) < 2 or ins[0].shape is None or ins[1].shape is None:
        return None
    x, w = ins[0].shape, ins[1].shape
    if len(w) != 2 or w[0] <= 0 or len(x) < 2:
        return None
    prod = 1
    for ncol in range(len(x) - 1, 0, -1):
        d = x[ncol]
        if d < 0:
            return None
        prod *= d
        if prod == w[0]:
            return (tuple(range(ncol, len(x))), (0,))
        if prod > w[0]:
            return None
    return None


def _contract_attention(op, ins):
    """Declared contraction dims of the fused SDPA (QK^T over the head
    dim) — metadata for the report; the propagator's ``attention`` rule
    only passes batch-only layouts through."""
    if len(ins) < 2 or ins[0].shape is None or ins[1].shape is None:
        return None
    return ((len(ins[0].shape) - 1,), (len(ins[1].shape) - 1,))


def _reduce_all(op, ins):
    if not ins or ins[0].shape is None:
        return None
    return tuple(range(len(ins[0].shape)))


def _reduce_attr(op, ins):
    """reduce_* family: the ``dim`` attr (None = all dims)."""
    if not ins or ins[0].shape is None:
        return None
    dim = op.attrs.get("dim")
    if dim is None:
        return tuple(range(len(ins[0].shape)))
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    r = len(ins[0].shape)
    return tuple(sorted(int(d) % r for d in dims))


def _reduce_last(op, ins):
    """Per-row losses: reduce over the class (last) dim."""
    if not ins or ins[0].shape is None or len(ins[0].shape) < 1:
        return None
    return (len(ins[0].shape) - 1,)


# ops that normalize over the last dim: comm-free only when it is
# unsharded (a tp-sharded softmax needs partial-max/sum all-reduces
# whose count is the partitioner's choice — degrade, never guess)
_COMM_ROWWISE = ("softmax", "log_softmax", "sequence_softmax",
                 "l2_normalize", "layer_norm")

register_comm(*(t for t in _UNARY_SAME if t not in _COMM_ROWWISE),
              kind="elementwise")
register_comm(*_COMM_ROWWISE, kind="rowwise")
register_comm("elementwise_add", "elementwise_sub", "elementwise_mul",
              "elementwise_div", "elementwise_max", "elementwise_min",
              "elementwise_pow", "sum", "square_error_cost",
              kind="elementwise")
register_comm("matmul", kind="contraction", contract=_contract_matmul)
register_comm("mul", "int8_mul_dequant", kind="contraction",
              contract=_contract_mul)
register_comm("fused_attention", kind="attention",
              contract=_contract_attention)
register_comm("mean", kind="reduction", reduce_dims=_reduce_all)
register_comm("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
              "reduce_prod", kind="reduction", reduce_dims=_reduce_attr)
register_comm("cross_entropy", "softmax_with_cross_entropy",
              kind="reduction", reduce_dims=_reduce_last)
register_comm("cast", "quantize_act", "amp_scale_loss",
              kind="passthrough")
register_comm("amp_cast_params", "amp_check_finite_and_unscale",
              "amp_update_loss_scaling", kind="mirror")
register_comm("transpose", kind="transpose")
register_comm("sharding_constraint", kind="constraint")
register_comm("fill_constant", kind="replicated_out")
register_comm("lookup_table", "token_lookup", kind="gather_table")
