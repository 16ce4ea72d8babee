"""Op-graph fusion + elimination passes for inference programs
(counterpart of paddle_tpu/passes/fusion.py, the same passes and
matchers). Reference: the inference analysis framework's fuse passes
(paddle/fluid/inference/analysis/analyzer.h — fc_fuse_pass,
attention-style subgraph fusion in inference/tensorrt/convert/,
transpose_flatten_concat_fuse_pass).

A fused op replays its chain of op fns over a private environment
(:func:`fuse_op_chain`), so fusion needs no new op: what it buys in the
port is a shorter op list for the executor to walk. Fused and dead
intermediates disappear from the environment — these passes are for
INFERENCE programs (save_inference_model) whose fetch targets are
declared, not for training programs whose every intermediate must stay
fetchable.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

from ..analysis.dataflow import (backward_live_ops, consumer_counts,
                                 producer_index)
from ..core.program import Operator, Program
from .base import Pass, register_pass

_ACT_TYPES = frozenset({
    "relu", "sigmoid", "tanh", "exp", "softsign", "softplus", "relu6",
    "gelu", "logsigmoid", "tanh_shrink", "softmax", "brelu",
    "leaky_relu", "elu", "hard_sigmoid", "swish"})
_FC_TYPES = frozenset({"mul", "matmul", "elementwise_add", "sum", "scale"})
_ELTWISE_CHAIN_TYPES = frozenset({
    "scale", "elementwise_add", "elementwise_mul", "elementwise_sub",
    "elementwise_div", "cast", "dropout"})

# The def-use primitives live in analysis/dataflow.py, shared by the
# pass matchers and the DCE sweep.
_consumer_counts = consumer_counts
_producer_index = producer_index


def _keep_digest(keep) -> str:
    text = ",".join(sorted(keep))
    return hashlib.sha256(text.encode()).hexdigest()[:12]


def fuse_op_chain(chain):
    """Compose a linear chain of Operators into one (fn, external_inputs,
    outputs): the fused fn replays the chain over a private mini-env, so
    any producer/consumer op pair the pattern matchers select fuses the
    same way. Attr-kwargs (``_fn_attrs``) are bound at fuse time — valid
    for inference programs, whose attrs are static."""
    bound, produced, ext_inputs = [], set(), []
    for op in chain:
        kw = {a: op.attrs[a] for a in op.attrs.get("_fn_attrs", ())}
        bound.append((op.fn, kw, tuple(op.input_arg_names),
                      tuple(op.output_arg_names)))
        for n in op.input_arg_names:
            if n not in produced and n not in ext_inputs:
                ext_inputs.append(n)
        produced.update(op.output_arg_names)
    out_names = tuple(chain[-1].output_arg_names)

    def fused(*args):
        env = dict(zip(ext_inputs, args))
        for f, kw, ins, outs in bound:
            out = f(*[env[n] for n in ins], **kw)
            if len(outs) == 1 and not isinstance(out, (tuple, list)):
                env[outs[0]] = out
            else:
                env.update(zip(outs, out))
        if len(out_names) == 1:
            return env[out_names[0]]
        return tuple(env[n] for n in out_names)

    return fused, ext_inputs, list(out_names)


def _splice_chain(gb, idxs, fused_type):
    """Replace ops at ``idxs`` (ascending, forming one chain) with a
    single fused op at the last position."""
    chain = [gb.ops[i] for i in idxs]
    fn, ext_inputs, outs = fuse_op_chain(chain)
    fused = Operator(gb, fused_type, inputs={"X": ext_inputs},
                     outputs={"Out": outs}, attrs={}, fn=fn)
    gb.ops[idxs[-1]] = fused
    for i in reversed(idxs[:-1]):
        del gb.ops[i]
    gb.program._version += 1


class _FusePassBase(Pass):
    """Shared scan loop: subclasses yield chains (lists of ascending op
    indices) to fuse via ``match(ops, i, counts, prod)`` returning the
    chain ending at op i, or None. ``keep`` names (declared fetch
    targets) are barriers: an op producing one may only sit at the TAIL
    of a chain — fusing it away would delete a fetchable value."""

    fused_type = "fused"

    def __init__(self, keep: Sequence[str] = ()):
        self.keep = set(keep)

    def fingerprint(self) -> str:
        return f"{self.name}/keep:{_keep_digest(self.keep)}"

    def apply(self, program: Program, scope=None) -> Program:
        gb = program.global_block()
        changed = True
        while changed:
            changed = False
            counts = _consumer_counts(gb.ops)
            prod = _producer_index(gb.ops)
            for i in range(len(gb.ops)):
                idxs = self.match(gb.ops, i, counts, prod)
                if idxs and not any(
                        n in self.keep
                        for j in idxs[:-1]
                        for n in gb.ops[j].output_arg_names):
                    _splice_chain(gb, idxs, self.fused_type)
                    changed = True
                    break
        return program


@register_pass("fc_act_fuse")
class FcActFusePass(_FusePassBase):
    """Fuse the fc chain (mul → [sum] → elementwise_add) with its trailing
    activation into one op (reference: fc_fuse_pass.cc + fc_act
    onednn fusion). Each intermediate must have exactly one consumer."""

    fused_type = "fc_act_fused"
    reads = _ACT_TYPES | _FC_TYPES
    writes = frozenset({"fc_act_fused"})

    def match(self, ops, i, counts, prod):
        op = ops[i]
        if op.type not in _ACT_TYPES or len(op.input_arg_names) != 1:
            return None
        idxs = [i]
        cur = op.input_arg_names[0]
        while True:
            j = prod.get(cur)
            if j is None or ops[j].fn is None:
                break
            p = ops[j]
            if (p.type not in _FC_TYPES or counts.get(cur, 0) != 1
                    or len(p.output_arg_names) != 1):
                break
            idxs.append(j)
            # continue only up a single-input spine (the fc data path:
            # first input is the data operand, rest are params)
            cur = p.input_arg_names[0]
            if p.type in ("mul", "matmul"):
                break  # the projection is the chain head
        if len(idxs) < 2:
            return None
        return sorted(idxs)


@register_pass("attention_fuse")
class AttentionFusePass(_FusePassBase):
    """Fuse the primitive-built attention core — matmul(Q,K) →
    scale/mask-add/… → softmax → [dropout] → matmul(·,V) — into one op
    (reference: the TensorRT subgraph converters,
    inference/tensorrt/convert/; multihead_matmul fusion)."""

    fused_type = "attention_fused"
    reads = frozenset({"matmul", "softmax"}) | _ELTWISE_CHAIN_TYPES
    writes = frozenset({"attention_fused"})

    def match(self, ops, i, counts, prod):
        tail = ops[i]
        if tail.type != "matmul":
            return None
        # walk back from the probability operand through the softmax chain
        probs = tail.input_arg_names[0]
        idxs = [i]
        cur = probs
        seen_softmax = False
        while True:
            j = prod.get(cur)
            if j is None or ops[j].fn is None:
                break
            p = ops[j]
            if counts.get(cur, 0) != 1 or len(p.output_arg_names) != 1:
                break
            if p.type == "softmax":
                seen_softmax = True
                idxs.append(j)
                cur = p.input_arg_names[0]
                continue
            if p.type in _ELTWISE_CHAIN_TYPES:
                idxs.append(j)
                cur = p.input_arg_names[0]
                continue
            if seen_softmax and p.type == "matmul":
                idxs.append(j)  # the QK^T head
                return sorted(idxs)
            break
        return None


@register_pass("transpose_eliminate")
class TransposeEliminatePass(Pass):
    """Cancel/merge adjacent transposes: transpose(p2) ∘ transpose(p1)
    becomes one transpose of the composed permutation, or disappears when
    the composition is the identity (reference:
    transpose_flatten_concat_fuse_pass.cc).
    ``keep`` names (declared fetch targets) are never eliminated.
    """

    reads = frozenset({"transpose"})
    writes = frozenset({"transpose", "identity"})

    def __init__(self, keep: Sequence[str] = ()):
        self.keep = set(keep)

    def fingerprint(self) -> str:
        return f"{self.name}/keep:{_keep_digest(self.keep)}"

    def apply(self, program: Program, scope=None) -> Program:
        gb = program.global_block()
        changed = True
        while changed:
            changed = False
            counts = _consumer_counts(gb.ops)
            prod = _producer_index(gb.ops)
            for i, op in enumerate(gb.ops):
                if op.type != "transpose":
                    continue
                src = op.input_arg_names[0]
                j = prod.get(src)
                if (j is None or gb.ops[j].type != "transpose"
                        or counts.get(src, 0) != 1 or src in self.keep):
                    continue
                first = gb.ops[j]
                p1 = list(first.attrs["perm"])
                p2 = list(op.attrs["perm"])
                combined = [p1[k] for k in p2]
                x_in = first.input_arg_names[0]
                out_name = op.output_arg_names[0]
                if combined == list(range(len(combined))):
                    fn = lambda v: v
                    new_type = "identity"
                    attrs = {}
                else:
                    fn = (lambda v, _p=tuple(combined): v.permute(_p))
                    new_type = "transpose"
                    attrs = {"perm": combined}
                gb.ops[i] = Operator(
                    gb, new_type, inputs={"X": [x_in]},
                    outputs={"Out": [out_name]}, attrs=attrs, fn=fn)
                del gb.ops[j]
                gb.program._version += 1
                changed = True
                break
        return program


@register_pass("dce")
class DeadCodeEliminatePass(Pass):
    """Drop pure ops whose outputs nobody reads (reference:
    framework/ir/graph_helper + the analysis passes' ir_graph_clean).
    Liveness roots: ``keep`` names (the exported fetch targets),
    persistable vars, and the inputs of structural/side-effecting ops
    (feed/fetch markers, print, control flow)."""

    _SIDE_EFFECTS = frozenset({"print", "while", "conditional_block",
                               "parallel_do"})
    reads = frozenset()   # DCE inspects liveness, not specific families
    writes = frozenset()  # removes ops, introduces none

    def __init__(self, keep: Sequence[str] = ()):
        self.keep = set(keep)

    def fingerprint(self) -> str:
        return f"{self.name}/keep:{_keep_digest(self.keep)}"

    def apply(self, program: Program, scope=None) -> Program:
        gb = program.global_block()
        roots = set(self.keep)
        roots.update(n for n, v in gb.vars.items() if v.persistable)
        mask = backward_live_ops(
            gb.ops, roots,
            lambda op: op.fn is None or op.type in self._SIDE_EFFECTS)
        if not all(mask):
            gb.ops[:] = [op for op, keep in zip(gb.ops, mask) if keep]
            program._version += 1
        return program
