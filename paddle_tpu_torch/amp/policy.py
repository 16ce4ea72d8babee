"""Per-op mixed-precision policy: allow / deny / infer lists
(counterpart of paddle_tpu/amp/policy.py, whose lists and fingerprint
this module keeps byte for byte, so a policy hashes alike in both
packages).

The three-way split of every autocast ("Mixed Precision Training",
Micikevicius et al., ICLR 2018, §3; bf16 per Kalamkar et al. 2019),
from the float16_transpiler's partition of op classes:

  * ALLOW  — matmul-class ops: compute in bf16 (the tensor cores
    multiply bf16 and accumulate f32), results stay bf16 so the
    activation stream between ops is half-width.
  * DENY   — precision-sensitive ops: softmax/exp/log, norms,
    reductions, losses. Inputs are cast back to f32 and the op runs at
    full precision.
  * INFER  — elementwise/shape ops: follow their inputs. No casts are
    inserted; a mixed bf16/f32 input set resolves by the op's own
    arithmetic (torch promotes to f32).

Ops in none of the lists take ``default_action`` — "deny" by default:
an op the policy has never heard of runs f32, never silently bf16.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Optional

# matmul/conv/attention families (layers/nn.py fc->mul,
# layers/conv.py, models/transformer.py fused_attention)
DEFAULT_ALLOW = frozenset({
    "mul", "matmul", "conv2d", "conv2d_transpose", "depthwise_conv2d",
    "conv3d", "sequence_conv", "fused_attention",
    # the decode rewrite's paged variants keep fused_attention's math
    # (f32 softmax inside); allowing them puts the KV pools — created
    # with the K/V stream dtype — on the bf16 stream for bf16 serving
    "paged_attention_prefill", "paged_attention_decode",
})

# precision-sensitive: reductions, normalizations, transcendentals with
# large dynamic range, and every loss head (their fns already reduce in
# f32 internally; the deny cast guarantees their INPUTS are f32 too)
DEFAULT_DENY = frozenset({
    "softmax", "log_softmax", "sequence_softmax", "softmax_with_cross_entropy",
    "cross_entropy", "fused_linear_softmax_ce", "square_error_cost",
    "layer_norm", "batch_norm", "l2_normalize",
    "mean", "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
    "reduce_prod", "sequence_pool", "pool2d_global",
    "exp", "log", "rsqrt", "reciprocal", "logsigmoid", "softplus",
    "lookup_table", "token_lookup", "sampled_softmax", "hsigmoid", "nce", "crf", "ctc",
})

# elementwise / data-movement: follow inputs, insert nothing
DEFAULT_INFER = frozenset({
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "sum", "scale", "cast", "clip",
    "relu", "relu6", "leaky_relu", "brelu", "elu", "gelu", "swish",
    "sigmoid", "tanh", "tanh_shrink", "softsign", "hard_sigmoid",
    "abs", "square", "sqrt", "sin", "cos", "ceil", "floor", "round",
    "dropout", "identity", "assign", "snapshot", "label_smooth",
    "sharding_constraint",  # layout annotation: dtype-transparent
    "reshape", "squeeze", "unsqueeze", "transpose", "concat", "split",
    "stack", "expand", "slice", "pad", "pos_encoding",
    "pos_encoding_at", "gather_last_token", "last_token_logits",
    "greedy_token", "pool2d",
    "sequence_expand", "sequence_reshape", "one_hot", "pow",
})


class AmpPolicy:
    """User-overridable three-way op partition.

    ``allow``/``deny``/``infer`` replace the default lists wholesale
    when given; ``extra_allow``/``extra_deny``/``extra_infer`` adjust
    the defaults incrementally (promote a custom fused op into the bf16
    set, or pin one more op to f32). An ``extra_*`` op overrides
    whatever default list it was in — ``extra_deny=["conv2d"]`` really
    does force conv2d to f32; naming one op in two ``extra_*`` lists is
    a contradiction and raises."""

    def __init__(self,
                 allow: Optional[Iterable[str]] = None,
                 deny: Optional[Iterable[str]] = None,
                 infer: Optional[Iterable[str]] = None,
                 extra_allow: Iterable[str] = (),
                 extra_deny: Iterable[str] = (),
                 extra_infer: Iterable[str] = (),
                 default_action: str = "deny"):
        if default_action not in ("deny", "infer"):
            raise ValueError("default_action must be 'deny' or 'infer'")
        extra_allow = frozenset(extra_allow)
        extra_deny = frozenset(extra_deny)
        extra_infer = frozenset(extra_infer)
        clash = ((extra_allow & extra_deny) | (extra_allow & extra_infer)
                 | (extra_deny & extra_infer))
        if clash:
            raise ValueError(
                f"op(s) {sorted(clash)} named in more than one extra_* "
                "list — pick one class per op")
        # explicit extra_* placement beats every default list
        self.allow = ((frozenset(allow if allow is not None
                                 else DEFAULT_ALLOW) | extra_allow)
                      - extra_deny - extra_infer)
        self.deny = ((frozenset(deny if deny is not None
                                else DEFAULT_DENY) | extra_deny)
                     - self.allow - extra_infer)
        self.infer = ((frozenset(infer if infer is not None
                                 else DEFAULT_INFER) | extra_infer)
                      - self.allow - self.deny)
        self.default_action = default_action

    def classify(self, op_type: str) -> str:
        """'allow' | 'deny' | 'infer' for one op type."""
        if op_type in self.allow:
            return "allow"
        if op_type in self.deny:
            return "deny"
        if op_type in self.infer:
            return "infer"
        return self.default_action

    def fingerprint(self) -> str:
        """Stable short digest of the full partition — composed into the
        program's amp stamp so compile-cache fingerprints distinguish
        programs rewritten under different policies."""
        text = "|".join([
            ",".join(sorted(self.allow)), ",".join(sorted(self.deny)),
            ",".join(sorted(self.infer)), self.default_action])
        return hashlib.sha256(text.encode()).hexdigest()[:16]

    def __repr__(self):
        return (f"AmpPolicy(allow={len(self.allow)}, deny={len(self.deny)},"
                f" infer={len(self.infer)}, "
                f"default={self.default_action!r})")
