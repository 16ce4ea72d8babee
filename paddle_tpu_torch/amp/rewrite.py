"""Graph-level autocast: rewrite a Program's IR for bf16 mixed precision
(counterpart of paddle_tpu/amp/rewrite.py).

Mixed precision as a program rewrite over the IR rather than a
build-time layer flag (the float16_transpiler lineage), so already-built
programs and ``load_inference_model`` artifacts can be retrofitted. The
build-time ``use_bfloat16`` / ``bf16_activations`` flags remain; this
pass subsumes them for any program that already exists.

One in-order walk per block, driven by the
:class:`~paddle_tpu_torch.amp.policy.AmpPolicy` partition:

  * ALLOW ops get every float32 input cast to bf16; their float outputs
    (and symbol-table declarations) become bf16.
  * DENY ops get every bf16 input cast back to f32.
  * INFER ops are left untouched; their output dtypes are re-derived
    from whatever now flows in.

Casts are minimal: at most one ``cast`` op per (source var, target
dtype), reused until the source is redefined, and never chained (each
op is visited once with its original input names, so a cast's source is
always an original var). Every float32 parameter an ALLOW op reads is
cast by ONE ``amp_cast_params`` op per block: the f32 master weights
stay in the scope, and the step's bf16 working copy is one op. A cast
rounds to nearest even, as ``astype`` does in the JAX package.

Output dtypes are re-derived by evaluating each rewritten op's fn on
``device="meta"`` tensors — the static tier's abstract evaluation
(``analysis.infer._abstract_eval``), where the JAX package runs
``jax.eval_shape`` — so a rewritten program checks clean under
``paddle_tpu_torch.analysis``.

A program that already holds a ``backward`` op is refused, as in the
JAX package: rewrite before ``append_backward``, or use
:func:`paddle_tpu_torch.amp.decorate`, which does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..core import dtype_utils, unique_name
from ..core.enforce import enforce
from ..core.program import Block, Operator, Parameter, Program
from .policy import AmpPolicy

_BF16 = "bfloat16"
_F32 = "float32"


def _name(dtype) -> str:
    return dtype_utils.name(dtype)


def _is_float(dtype) -> bool:
    try:
        return dtype_utils.to_torch(dtype).is_floating_point
    except (KeyError, TypeError):
        return False


def _insert_op(block: Block, idx: int, type: str, inputs, outputs,
               attrs=None, fn=None) -> Operator:
    """Insert an op at ``idx`` with append_op's bookkeeping (producer
    links, version bump) but no build-time shape inference: the
    rewriter sets output shapes and dtypes itself."""
    op = Operator(block, type, inputs, outputs, attrs or {}, fn)
    block.ops.insert(idx, op)
    for name in op.output_arg_names:
        v = block._find_var_recursive(name)
        if v is not None and v.op is None:
            v.op = op
    block.program._bump()
    return op


def _unique_var(block: Block, base: str) -> str:
    name = base
    while block._find_var_recursive(name) is not None:
        name = unique_name.generate(base)
    return name


class _BlockRewriter:
    def __init__(self, block: Block, policy: AmpPolicy):
        self.block = block
        self.policy = policy
        # (source name, dtype tag) -> cast output name; a source's
        # entries are dropped when a later op redefines it
        self.cache: Dict[Tuple[str, str], str] = {}
        self.n_casts = 0

    def _var(self, name):
        return self.block._find_var_recursive(name)

    # -- cast plumbing -------------------------------------------------
    def _cast_to(self, idx: int, name: str, tgt: str) -> Tuple[str, int]:
        """Name of ``name``'s value in dtype ``tgt``, inserting at most
        one cast op before position ``idx``: (name, new idx)."""
        tag = "bf16" if tgt == _BF16 else tgt
        hit = self.cache.get((name, tag))
        if hit is not None:
            return hit, idx
        var = self._var(name)
        out_name = _unique_var(self.block, f"{name}@amp.{tag}")
        self.block.create_var(
            name=out_name, shape=None if var is None else var.shape,
            dtype=tgt)
        t = dtype_utils.to_torch(tgt)
        _insert_op(self.block, idx, "cast",
                   inputs={"X": [name]}, outputs={"Out": [out_name]},
                   attrs={"dtype": tgt, "_amp_inserted": True},
                   fn=lambda v, _t=t: v.to(_t))
        self.cache[(name, tag)] = out_name
        self.n_casts += 1
        return out_name, idx + 1

    def _rewrite_inputs(self, op: Operator, idx: int, tgt: str,
                        only_from: str) -> int:
        for names in op.inputs.values():
            for j, n in enumerate(names):
                v = self._var(n)
                if v is None or not _is_float(v.dtype):
                    continue
                if _name(v.dtype) != only_from:
                    continue
                new, idx = self._cast_to(idx, n, tgt)
                names[j] = new
        return idx

    # -- output dtype refresh ------------------------------------------
    def _refresh_outputs(self, op: Operator, action: str) -> None:
        out_vars = [self._var(n) for n in op.output_arg_names]
        touch = [v for v in out_vars
                 if v is not None and not v.is_data and _is_float(v.dtype)]
        if not touch:
            return
        inferred = self._abstract_out_dtypes(op)
        if inferred is not None:
            for v, dt in zip(out_vars, inferred):
                if (v is not None and not v.is_data and dt is not None
                        and _is_float(v.dtype) and _is_float(dt)):
                    v.dtype = dtype_utils.normalize_dtype(dt)
            return
        # the fn cannot be evaluated abstractly: the class decides
        if action == "allow":
            new = _BF16
        elif action == "deny":
            new = _F32
        else:
            in_dts = [_name(self._var(n).dtype) for n in op.input_arg_names
                      if self._var(n) is not None
                      and _is_float(self._var(n).dtype)]
            new = _BF16 if in_dts and all(d == _BF16 for d in in_dts) \
                else _F32
        for v in touch:
            v.dtype = dtype_utils.normalize_dtype(new)

    def _abstract_out_dtypes(self, op: Operator) -> Optional[list]:
        """The op's output dtypes from its fn on meta tensors, or None
        when it cannot tell (the rewrite never fails on an odd fn)."""
        from ..analysis.infer import _abstract_eval
        from ..analysis.op_registry import TensorType

        ins = []
        for n in op.input_arg_names:
            v = self._var(n)
            if v is None or v.shape is None:
                return None
            ins.append(TensorType(v.shape, v.dtype))
        try:
            outs = _abstract_eval(op, ins)
        except Exception:
            return None
        if outs is None:
            return None
        return [t.dtype for t in outs]

    # -- the walk -------------------------------------------------------
    def _fuse_param_casts(self) -> None:
        """ONE ``amp_cast_params`` op casting every f32 Parameter an
        ALLOW op reads: the step's bf16 copy of the master weights."""
        needed: List[str] = []
        first_use = None
        for i, op in enumerate(self.block.ops):
            if op.fn is None or self.policy.classify(op.type) != "allow":
                continue
            for n in op.input_arg_names:
                v = self._var(n)
                if (isinstance(v, Parameter) and _name(v.dtype) == _F32
                        and n not in needed):
                    needed.append(n)
                    if first_use is None:
                        first_use = i
        if not needed:
            return
        outs = []
        for n in needed:
            v = self._var(n)
            out_name = _unique_var(self.block, f"{n}@amp.bf16")
            self.block.create_var(name=out_name, shape=v.shape,
                                  dtype=_BF16)
            self.cache[(n, "bf16")] = out_name
            outs.append(out_name)

        def fn(*ps):
            return tuple(p.to(torch.bfloat16) for p in ps)

        _insert_op(self.block, first_use, "amp_cast_params",
                   inputs={"Params": list(needed)},
                   outputs={"Out": outs},
                   attrs={"dtype": "bfloat16", "_amp_inserted": True},
                   fn=fn)
        self.n_casts += 1

    def run(self) -> int:
        self._fuse_param_casts()
        i = 0
        while i < len(self.block.ops):
            op = self.block.ops[i]
            if (op.fn is None or op.attrs.get("_non_tensor_out")
                    or op.attrs.get("_amp_inserted")):
                i += 1
                continue
            action = self.policy.classify(op.type)
            if action == "allow":
                i = self._rewrite_inputs(op, i, _BF16, only_from=_F32)
            elif action == "deny":
                i = self._rewrite_inputs(op, i, _F32, only_from=_BF16)
            self._refresh_outputs(op, action)
            # a redefinition of a cached cast source invalidates it
            for n in op.output_arg_names:
                for key in [k for k in self.cache if k[0] == n]:
                    del self.cache[key]
            i += 1
        return self.n_casts


def rewrite_program(program: Program,
                    policy: Optional[AmpPolicy] = None) -> Program:
    """Rewrite ``program`` IN PLACE for bf16 mixed precision; returns it.

    Works on freshly built forward programs, their clones and
    ``load_inference_model`` artifacts (any Program whose ops carry
    their fns). Training programs are rewritten before
    ``append_backward`` (:func:`paddle_tpu_torch.amp.decorate` does so).
    Sets ``program._amp_stamp`` (``"bfloat16/<policy fingerprint>"``,
    kept by clones) and ``program._amp_cast_count`` (the casts this call
    inserted), and bumps the program's version."""
    policy = policy or AmpPolicy()
    for b in program.blocks:
        for op in b.ops:
            enforce(op.type != "backward",
                    "amp.rewrite_program cannot rewrite a program that "
                    "already has a backward op (its gradient is taken over "
                    "the forward ops as they stand) — rewrite before "
                    "append_backward, or use amp.decorate(optimizer)")
    n = 0
    for b in program.blocks:
        n += _BlockRewriter(b, policy).run()
    program._amp_stamp = f"bfloat16/{policy.fingerprint()}"
    program._amp_cast_count = n
    return program
