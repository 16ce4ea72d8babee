"""Whole-program transforms (counterpart of
paddle_tpu/passes/transforms.py): the inference-time rewrites — conv+BN
fold (``InferenceTranspiler``, the registered ``conv_bn_fold`` pass;
reference: transpiler/inference_transpiler.py:22) and the bf16 parameter
cast (``transpile_to_bfloat16``, the ``cast_params_bf16`` pass;
reference: contrib/float16/float16_transpiler.py) — and memory
optimization (``memory_optimize`` and ``release_memory``, and the
registered ``memory_optimize`` pass; reference:
transpiler/memory_optimization_transpiler.py:366,385) — and the
graph-level bf16 autocast as the registered ``amp_bf16`` pass (wraps
``amp.rewrite_program``).

The fold computes the folded weights as the JAX package does, in
float64 on the host, and writes them back in the parameters' dtype on
their device.

Every level marks the program so that the executor updates its state
in place whatever the ``donate_state_buffers`` flag says
(``Executor._resolve_donation``): the ops write the scope's own
parameters and moments, and ``Executor.run_steps``' captured graph
reads and writes them where they lie, with no copy in or out. Level
>= 1 also recomputes the backward's forward slice (the all-or-nothing
remat flag, set through ``passes.schedule.apply_remat_policy(
segments="all")``; the executor runs the slice under
``torch.utils.checkpoint``). ``print_log`` prints the static peak-memory
report of ``analysis.analyze_liveness``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.program import Operator, Program, default_main_program
from ..core.scope import Scope, global_scope
from .base import Pass, register_pass

# ---------------------------------------------------------------------------
# conv+BN fold (the InferenceTranspiler)
# ---------------------------------------------------------------------------


def _consumers(program: Program, name: str):
    return [op for op in program.global_block().ops
            if name in op.input_arg_names]


def _host64(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


def _store(scope: Scope, name: str, value: np.ndarray, like) -> None:
    """``value`` (float64) into ``scope[name]`` in ``like``'s dtype and
    on its device."""
    dt = np.float64 if like.dtype == torch.float64 else np.float32
    scope.set_var(name, torch.from_numpy(value.astype(dt)).to(
        device=like.device, dtype=like.dtype))


class InferenceTranspiler:
    """reference: transpiler/inference_transpiler.py:22."""

    def transpile(self, program: Program, place=None,
                  scope: Optional[Scope] = None) -> Program:
        """Fold every eligible is_test batch_norm into its upstream conv2d.

        Mutates ``scope`` parameter values (like the reference, which
        rewrites the vars in the scope) and returns a rewritten program;
        the input program is not modified."""
        scope = scope or global_scope()
        out = program.clone(for_test=True)
        gb = out.global_block()

        i = 0
        while i < len(gb.ops):
            op = gb.ops[i]
            if op.type != "batch_norm" or not op.attrs.get("is_test", False):
                i += 1
                continue
            x_name = op.input("X")[0]
            producer = None
            for prev in gb.ops[:i]:
                if x_name in prev.output_arg_names:
                    producer = prev
            # pattern: conv2d (no bias) or conv2d -> elementwise_add(bias)
            conv_op, bias_op = None, None
            if producer is not None and producer.type == "conv2d":
                conv_op = producer
            elif (producer is not None
                  and producer.type == "elementwise_add"
                  and len(producer.input_arg_names) == 2):
                maybe_conv_out = producer.input_arg_names[0]
                for prev in gb.ops[:i]:
                    if maybe_conv_out in prev.output_arg_names \
                            and prev.type == "conv2d":
                        conv_op, bias_op = prev, producer
            if conv_op is None or len(_consumers(out, x_name)) != 1:
                i += 1
                continue

            w_name = conv_op.input("Filter")[0]
            scale_n = op.input("Scale")[0]
            bias_n = op.input("Bias")[0]
            mean_n = op.input("Mean")[0]
            var_n = op.input("Variance")[0]
            needed = [w_name, scale_n, bias_n, mean_n, var_n]
            if bias_op is not None:
                needed.append(bias_op.input_arg_names[1])
            if not all(scope.has_var(n) for n in needed):
                i += 1  # params not materialized: leave this BN alone
                continue

            eps = float(op.attrs.get("epsilon", 1e-5))
            gamma = _host64(scope.get(scale_n))
            beta = _host64(scope.get(bias_n))
            mean = _host64(scope.get(mean_n))
            var = _host64(scope.get(var_n))
            alpha = gamma / np.sqrt(var + eps)  # per out-channel scale

            w = scope.get(w_name)
            _store(scope, w_name, _host64(w) * alpha.reshape(-1, 1, 1, 1), w)
            if bias_op is not None:
                cb_name = bias_op.input_arg_names[1]
                cb = _host64(scope.get(cb_name))
                _store(scope, cb_name, (cb - mean) * alpha + beta, w)
                # BN output now equals the bias-add output
                tail_op = bias_op
            else:
                # conv had no bias: the folded shift needs one — reuse the
                # BN bias var as the new conv bias
                _store(scope, bias_n, beta - mean * alpha, w)
                conv_out = conv_op.output("Output")[0]
                gb.ops[i] = Operator(
                    gb, "elementwise_add",
                    inputs={"X": [conv_out], "Y": [bias_n]},
                    outputs={"Out": [op.output("Y")[0]]},
                    attrs={},
                    fn=lambda x, b: x + b.reshape((1, -1) + (1,) *
                                                  (x.dim() - 2)))
                out._bump()
                i += 1
                continue

            # rename the bias-add output to the BN output and drop the BN op
            bn_out = op.output("Y")[0]
            for slot, names in tail_op.outputs.items():
                tail_op.outputs[slot] = [bn_out if n == x_name else n
                                         for n in names]
            del gb.ops[i]
            out._bump()
        return out


def transpile_to_bfloat16(program: Program,
                          scope: Optional[Scope] = None) -> None:
    """Cast persistable float32 params in scope to bfloat16 (reference:
    contrib/float16/float16_transpiler.py — fp16 inference). Only the
    stored parameters change: a matrix product or convolution built
    under the bf16 flags casts its operands itself, and one built
    without them widens a bf16 operand to the other's type, as the JAX
    package's promotion does."""
    scope = scope or global_scope()
    gb = program.global_block()
    for name, v in gb.vars.items():
        if not v.persistable or not scope.has_var(name):
            continue
        val = scope.get(name)
        if isinstance(val, torch.Tensor) and val.dtype == torch.float32:
            scope.set_var(name, val.to(torch.bfloat16))


@register_pass("conv_bn_fold")
class ConvBNFoldPass(Pass):
    """Fold inference-mode batch_norm into the upstream conv's weights
    (reference: transpiler/inference_transpiler.py:22)."""

    mutates_scope = True
    reads = frozenset({"batch_norm", "conv2d", "elementwise_add"})
    writes = frozenset({"elementwise_add"})

    def fingerprint(self) -> str:
        return self.name

    def apply(self, program: Program, scope=None) -> Program:
        return InferenceTranspiler().transpile(program, scope=scope)


@register_pass("cast_params_bf16")
class CastParamsBF16Pass(Pass):
    """Cast persistable f32 params to bfloat16 for bf16 inference
    (reference: paddle/contrib/float16/float16_transpiler.py).
    Scope-only: the program is returned unchanged."""

    mutates_scope = True
    reads = frozenset()
    writes = frozenset()

    def fingerprint(self) -> str:
        return self.name

    def apply(self, program: Program, scope=None) -> Program:
        transpile_to_bfloat16(program, scope=scope)
        return program


# ---------------------------------------------------------------------------
# memory optimization (donation + remat flags)
# ---------------------------------------------------------------------------


def memory_optimize(input_program: Optional[Program] = None,
                    skip_opt_set=None, print_log: bool = False,
                    level: int = 0, assume_batch: int = 1) -> None:
    """Donation for ``input_program`` (default: the default main
    program) at every level; ``level >= 1`` adds remat of the backward's
    forward slice (recompute activations).

    ``print_log=True`` prints the static peak-memory report from the
    liveness engine (``analysis.analyze_liveness``, reference: the
    ControlFlowGraph liveness pass at
    memory_optimization_transpiler.py:35): peak resident bytes and the
    op where they occur, persistable-state total, and the largest
    tensors with their lifetime spans. Dynamic (-1) dims are counted as
    ``assume_batch`` extents — pass the training batch size for a
    real-traffic estimate."""
    del skip_opt_set
    program = input_program or default_main_program()
    program._memory_optimize = True
    if level >= 1:
        # the all-or-nothing remat flag, through the remat_policy
        # pass's "all" mode; stamp=False: the flag itself is what the
        # executor keys on
        from .schedule import apply_remat_policy

        apply_remat_policy(program, segments="all", stamp=False)
    else:
        program._memory_optimize_remat = False
    program._bump()
    if print_log:
        from ..analysis import analyze_liveness

        report = analyze_liveness(program, assume_batch=assume_batch)
        print("memory_optimize: buffer donation on; remat %s"
              % ("on" if level >= 1 else "off"))
        print(report.render())


def release_memory(input_program: Optional[Program] = None,
                   skip_opt_set=None) -> None:
    """The reference inserts delete ops; PyTorch's caching allocator
    frees a tensor when its last reference goes, so there is nothing to
    insert. For the static picture of what is resident when, use
    ``memory_optimize(print_log=True)`` or
    ``analysis.analyze_liveness``. Kept for the API, as in the JAX
    package."""
    del input_program, skip_opt_set
    return None


@register_pass("memory_optimize")
class MemoryOptimizePass(Pass):
    """Buffer donation + optional remat flags (reference:
    transpiler/memory_optimization_transpiler.py:366)."""

    reads = frozenset()
    writes = frozenset()

    def __init__(self, level: int = 0):
        self.level = level

    def fingerprint(self) -> str:
        return f"{self.name}/level:{int(self.level)}"

    def apply(self, program: Program, scope=None) -> Program:
        memory_optimize(program, level=self.level)
        return program


# ---------------------------------------------------------------------------
# amp: the autocast rewrite as a registered pass
# ---------------------------------------------------------------------------


@register_pass("amp_bf16")
class AmpRewritePass(Pass):
    """Graph-level bf16 autocast (wraps
    :func:`paddle_tpu_torch.amp.rewrite_program`). Self-stamping: the
    rewrite sets ``program._amp_stamp`` itself, the same stamp as a
    direct call, which the pass manager verifies."""

    stamp_attr = "_amp_stamp"
    reads = frozenset({"*"})  # the policy partitions every op type
    writes = frozenset({"cast", "amp_cast_params"})

    def __init__(self, policy=None):
        self.policy = policy

    def fingerprint(self) -> str:
        from ..amp.policy import AmpPolicy

        policy = self.policy or AmpPolicy()
        return f"bfloat16/{policy.fingerprint()}"

    def apply(self, program: Program, scope=None) -> Program:
        from ..amp import rewrite_program

        return rewrite_program(program, policy=self.policy)


@register_pass("sharding")
class ShardingPass(Pass):
    """Named-mesh SPMD sharding (wraps
    :func:`paddle_tpu_torch.sharding.shard_program`; docs/SHARDING.md).
    Self-stamping via ``_sharding_stamp``; a 1-device mesh (or
    ``mesh=None``) leaves the program untouched — the manager sees no
    change and composes nothing, keeping single-device fingerprints
    byte-identical.

    To see the collectives a plan implies before compiling, run the
    static comm analyzer over the stamped program: ``python -m
    paddle_tpu_torch.tools.check_program --model mlp --shard data=2,fsdp=2
    --comm`` (or ``analysis.analyze_comm(program)`` /
    ``PassManager(..., lint_comm=True)``)."""

    stamp_attr = "_sharding_stamp"
    reads = frozenset({"*"})  # partition rules match any producer
    writes = frozenset({"sharding_constraint"})

    def __init__(self, mesh=None, rules: Optional[Sequence] = None,
                 zero_shard_moments: bool = True):
        self.mesh = mesh
        self.rules = rules
        self.zero_shard_moments = zero_shard_moments

    def fingerprint(self) -> str:
        from ..sharding.rules import default_rules, rules_digest

        if self.mesh is None:
            return "sharding/none"
        rules = (list(self.rules) if self.rules is not None
                 else default_rules())
        return "mesh:%s/rules:%s" % (
            ",".join(f"{a}={s}"
                     for a, s in sorted(self.mesh.shape.items())),
            rules_digest(rules))

    def apply(self, program: Program, scope=None) -> Program:
        from ..sharding import shard_program

        return shard_program(program, self.mesh, rules=self.rules,
                             zero_shard_moments=self.zero_shard_moments)
