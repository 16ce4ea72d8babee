"""Abstract interpreter: propagate shapes/dtypes through every block
(counterpart of paddle_tpu/analysis/infer.py, the same sweep and
diagnostics).

Reference: the build-time InferShape sweep the C++ framework runs over a
ProgramDesc before execution (framework/shape_inference.h, called per op
from framework.py Operator.__init__). Two inference sources, in order:

1. a declarative rule from analysis/op_registry.py (the InferShapeFn
   equivalent — knows the op's *contract* and can therefore produce a
   targeted message when inputs violate it);
2. abstract evaluation of the op's torch fn on ``device="meta"`` tensors
   (shape and dtype, no data), where the JAX package runs
   ``jax.eval_shape``; the dynamic-dim sentinel and the test for
   "needs concrete values" are the build-time pass's own
   (``core/program.py``: ``_DYN_SENTINEL``, ``_DATA_DEPENDENT``).

Ops with neither (structural fn=None markers, non-tensor products)
degrade to UNKNOWN lattice values — never to a false positive.

Every inferred output is then checked against the symbol table's
declared shape/dtype; provable conflicts become shape-mismatch /
dtype-mismatch diagnostics carrying the op's context.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import torch

from ..core import dtype_utils
from ..core.program import (_DATA_DEPENDENT, _DYN_SENTINEL, LOD_TENSOR,
                            Block, Deferred)
from . import diagnostics as diag
from .diagnostics import Diagnostic
from .op_registry import (SignatureError, TensorType, UNKNOWN,
                          get_signature, meet, shapes_compatible)

_SENTINEL_IN_MESSAGE = re.compile(rf"(?<!\d){_DYN_SENTINEL}(?!\d)")


class InferResult:
    """Outcome of one inference sweep: final abstract env per block plus
    the mismatch diagnostics."""

    def __init__(self):
        # (block_idx, var_name) -> TensorType
        self.types: Dict[Tuple[int, str], TensorType] = {}
        self.diagnostics: List[Diagnostic] = []

    def type_of(self, name: str, block_idx: int = 0) -> TensorType:
        return self.types.get((block_idx, name), UNKNOWN)


def declared_type(var) -> TensorType:
    """Symbol-table entry -> lattice value. Non-tensor vars are UNKNOWN:
    nothing to check against."""
    if var is None or var.type != LOD_TENSOR:
        return UNKNOWN
    return TensorType(var.shape, var.dtype)


def _abstract_eval(op, ins: List[TensorType]) -> Optional[List[TensorType]]:
    """Run the op's fn over meta tensors. Returns one TensorType per
    declared output, None for "cannot tell" (unknown inputs, a fn that
    needs concrete values, a mismatched output count), or raises
    SignatureError when the evaluation itself reports a genuine
    shape/dtype conflict."""
    if op.fn is None or op.attrs.get("_non_tensor_out"):
        return None
    if any(t.shape is None or t.dtype is None for t in ins):
        return None
    metas = [torch.empty(tuple(_DYN_SENTINEL if s == -1 else s
                               for s in t.shape),
                         dtype=dtype_utils.to_torch(t.dtype), device="meta")
             for t in ins]
    kwargs = {a: op.attrs[a] for a in op.attrs.get("_fn_attrs", ())}
    try:
        with torch.no_grad():
            if metas:
                out = op.fn(*metas, **kwargs)
            else:
                with torch.device("meta"):
                    out = op.fn(**kwargs)
            outs = (out,) if not isinstance(out, (tuple, list)) \
                else tuple(out)
            outs = tuple(o.resolve() if isinstance(o, Deferred) else o
                         for o in outs)
    except Exception as e:
        if isinstance(e, NotImplementedError) or \
                _DATA_DEPENDENT.search(str(e)):
            return None
        if _SENTINEL_IN_MESSAGE.search(str(e)):
            # artifact of the symbolic-dim sentinel, not a real conflict
            return None
        raise SignatureError(f"abstract evaluation failed: {e}") from e
    if len(outs) != len(op.output_arg_names):
        return None
    result = []
    for o in outs:
        if not isinstance(o, torch.Tensor):  # a non-tensor product
            result.append(UNKNOWN)
            continue
        shape = tuple(-1 if s == _DYN_SENTINEL else int(s)
                      for s in o.shape)
        result.append(TensorType(shape, o.dtype))
    return result


def _infer_op(op, ins: List[TensorType]) -> Optional[List[TensorType]]:
    """Rule first, abstract evaluation second. May raise SignatureError."""
    rule = get_signature(op.type)
    if rule is not None:
        outs = rule(op, ins)
        if outs is not None:
            return list(outs)
    return _abstract_eval(op, ins)


def infer_block(block: Block, result: InferResult) -> None:
    env: Dict[str, TensorType] = {}

    def lookup(name: str) -> TensorType:
        if name in env:
            return env[name]
        return declared_type(block._find_var_recursive(name))

    any_lod = lambda names: any(  # noqa: E731
        getattr(block._find_var_recursive(n), "lod_level", 0)
        for n in names)

    for i, op in enumerate(block.ops):
        ins = [lookup(n) for n in op.input_arg_names]
        try:
            outs = _infer_op(op, ins)
        except SignatureError as e:
            if any_lod(op.input_arg_names):
                # ragged inputs may use the reference's PER-STEP shape
                # convention (time axis implicit); abstract shapes cannot
                # be trusted either way — same waiver as build time
                outs = None
            else:
                result.diagnostics.append(Diagnostic(
                    diag.ERROR, diag.SHAPE_MISMATCH, str(e),
                    block_idx=block.idx, op_idx=i, op_type=op.type))
                outs = None
        if outs is None:
            outs = [UNKNOWN] * len(op.output_arg_names)
        for name, inferred in zip(op.output_arg_names, outs):
            var = block._find_var_recursive(name)
            decl = declared_type(var)
            if not shapes_compatible(inferred.shape, decl.shape):
                result.diagnostics.append(Diagnostic(
                    diag.ERROR, diag.SHAPE_MISMATCH,
                    f"op infers shape {inferred.shape} but the symbol "
                    f"table declares {decl.shape}",
                    block_idx=block.idx, op_idx=i, op_type=op.type,
                    var=name))
                env[name] = decl  # trust the declaration; limit cascades
                continue
            if (inferred.dtype is not None and decl.dtype is not None
                    and var is not None and var.shape is not None
                    and inferred.dtype != decl.dtype):
                # only compare dtypes of vars with a declared shape: a
                # shapeless declaration never had its default-f32 dtype
                # corrected by build-time inference, so it carries no
                # information to contradict
                result.diagnostics.append(Diagnostic(
                    diag.ERROR, diag.DTYPE_MISMATCH,
                    f"op infers dtype {dtype_utils.name(inferred.dtype)} "
                    f"but the symbol table declares "
                    f"{dtype_utils.name(decl.dtype)}",
                    block_idx=block.idx, op_idx=i, op_type=op.type,
                    var=name))
                env[name] = decl
                continue
            env[name] = meet(inferred, decl)

    for name, t in env.items():
        result.types[(block.idx, name)] = t


def infer_program_types(program) -> InferResult:
    """Run shape/dtype inference over every block of ``program``. Fed
    names need no special seeding: their declared symbol-table types are
    the starting point for every external input."""
    result = InferResult()
    for block in program.blocks:
        infer_block(block, result)
    return result
