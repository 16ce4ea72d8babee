"""Program IR: program-as-data with a named symbol table (counterpart of
paddle_tpu/core/program.py).

An Operator carries a torch callable: ``fn(*input_tensors, **attrs)``
returns the output tensor or a tuple of them. The Executor runs the op
list eagerly. The symbol table (names, shapes, dtypes, persistable) is
kept exactly as in the JAX package, so the same builder calls give the
same table in both packages and programs can be rewritten by name.
"""

from __future__ import annotations

import contextlib
import copy
import re
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from . import dtype_utils, flags, unique_name
from .enforce import EnforceError, enforce

LOD_TENSOR = "lod_tensor"


class Variable:
    """Symbol-table entry."""

    def __init__(
        self,
        block: "Block",
        name: Optional[str] = None,
        shape: Optional[Sequence[int]] = None,
        dtype=None,
        lod_level: int = 0,
        persistable: bool = False,
        is_data: bool = False,
        stop_gradient: bool = False,
        type: str = LOD_TENSOR,
    ):
        self.block = block
        self.name = name or unique_name.generate("_generated_var")
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype_utils.normalize_dtype(dtype)
        self.lod_level = lod_level
        self.persistable = persistable
        self.is_data = is_data
        self.stop_gradient = stop_gradient
        self.type = type
        # op that produces this var (set by append_op); None for feed/param
        self.op: Optional[Operator] = None

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={dtype_utils.name(self.dtype)}, "
                f"persistable={self.persistable})")


class Parameter(Variable):
    """Trainable persistable variable."""

    def __init__(self, block, shape, dtype, name=None, initializer=None,
                 trainable: bool = True, regularizer=None, gradient_clip=None,
                 optimize_attr=None, **kw):
        super().__init__(block, name=name, shape=shape, dtype=dtype,
                         persistable=True, **kw)
        enforce(shape is not None, "Parameter must have a shape")
        self.initializer = initializer
        self.trainable = trainable
        self.regularizer = regularizer
        self.gradient_clip = gradient_clip
        self.optimize_attr = optimize_attr or {"learning_rate": 1.0}


class Operator:
    """One node of the program. ``fn(*input_values, **attrs)`` follows
    ``input_arg_names`` for its inputs and ``output_arg_names`` for its
    outputs."""

    def __init__(
        self,
        block: "Block",
        type: str,
        inputs: Dict[str, List[str]],
        outputs: Dict[str, List[str]],
        attrs: Optional[Dict[str, Any]] = None,
        fn: Optional[Callable] = None,
    ):
        self.block = block
        self.type = type
        self.inputs = {k: list(v) for k, v in inputs.items()}
        self.outputs = {k: list(v) for k, v in outputs.items()}
        self.attrs = dict(attrs or {})
        self.fn = fn

    @property
    def input_arg_names(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns]

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    def __repr__(self):
        return f"Op({self.type}: {self.input_arg_names} -> {self.output_arg_names})"


class Block:
    """Ordered op list + var symbol table."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    def create_var(self, **kw) -> Variable:
        name = kw.get("name")
        if name is not None and name in self.vars:
            return self.vars[name]
        v = Variable(self, **kw)
        self.vars[v.name] = v
        self.program._bump()
        return v

    def create_parameter(self, **kw) -> Parameter:
        p = Parameter(self, **kw)
        if p.name in self.vars:
            raise EnforceError(f"Parameter {p.name!r} already exists")
        self.vars[p.name] = p
        self.program._bump()
        if p.initializer is not None:
            p.initializer._append_init_op(p)
        return p

    def var(self, name: str) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise EnforceError(f"Variable {name!r} not found in block {self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name: str) -> Optional[Variable]:
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = (self.program.blocks[b.parent_idx]
                 if b.parent_idx >= 0 else None)
        return None

    def append_op(self, type: str, inputs=None, outputs=None, attrs=None,
                  fn: Optional[Callable] = None) -> Operator:
        op = Operator(self, type, inputs or {}, outputs or {}, attrs, fn)
        self.ops.append(op)
        for name in op.output_arg_names:
            v = self._find_var_recursive(name)
            if v is not None and v.op is None:
                v.op = op
        _infer_shapes(op, self)
        self.program._bump()
        return op

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def __repr__(self):
        return f"Block(idx={self.idx}, ops={len(self.ops)}, vars={len(self.vars)})"


class Program:
    """The program: a list of blocks (this slice builds one)."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self._current_block_idx = 0
        self.random_seed = 0
        self._version = 0  # bumped on mutation
        self._seed_counter = 0

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._current_block_idx]

    def _bump(self) -> None:
        self._version += 1

    def next_param_seed(self) -> int:
        self._seed_counter += 1
        return (self.random_seed * 1000003 + self._seed_counter) & 0x7FFFFFFF

    def clone(self, for_test: bool = False) -> "Program":
        """Copy the blocks, vars and ops (fns shared). With
        ``for_test=True`` ops carrying an ``is_test`` attr switch to
        inference behaviour."""
        p = Program.__new__(Program)
        p.random_seed = self.random_seed
        p._version = 0
        p._seed_counter = self._seed_counter
        p._current_block_idx = 0
        p.blocks = [Block(p, b.idx, b.parent_idx) for b in self.blocks]
        for b, nb in zip(self.blocks, p.blocks):
            for name, v in b.vars.items():
                nv = copy.copy(v)
                nv.block = nb
                nv.op = None
                nb.vars[name] = nv
            for op in b.ops:
                nop = Operator(nb, op.type, op.inputs, op.outputs,
                               dict(op.attrs), op.fn)
                if for_test and "is_test" in nop.attrs:
                    nop.attrs["is_test"] = True
                nb.ops.append(nop)
                for name in nop.output_arg_names:
                    v = nb._find_var_recursive(name)
                    if v is not None and v.op is None:
                        v.op = nop
        return p

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def all_parameters(self):
        return self.global_block().all_parameters()

    def __repr__(self):
        return f"Program(blocks={len(self.blocks)}, version={self._version})"


# -- shape inference ---------------------------------------------------------
#
# The op's own torch fn is the shape function: it runs on "meta" tensors,
# which carry shape and dtype and no data. The symbolic batch dim (-1) is
# substituted with a sentinel extent and mapped back afterwards, as in
# the JAX package (where jax.eval_shape plays this role).

_DYN_SENTINEL = 1297  # unlikely concrete extent standing in for -1

# meta-tensor failures that mean "this fn needs concrete values"
# (data-dependent shapes, .item() and the like) rather than "your shapes
# are wrong": skipped silently, like the JAX package's concretization
# errors
_DATA_DEPENDENT = re.compile(
    r"meta tensor|data-dependent|Cannot copy out of meta|"
    r"nonzero|item\(\)", re.IGNORECASE)


def _infer_shapes(op: "Operator", block: "Block") -> None:
    if op.fn is None:
        return
    out_vars = [block._find_var_recursive(n) for n in op.output_arg_names]
    if all(v is None or v.shape is not None for v in out_vars):
        return
    ins = []
    for n in op.input_arg_names:
        v = block._find_var_recursive(n)
        if v is None or v.shape is None:
            return
        shape = tuple(_DYN_SENTINEL if s == -1 else s for s in v.shape)
        ins.append(torch.empty(shape, dtype=dtype_utils.to_torch(v.dtype),
                               device="meta"))
    kwargs = {a: op.attrs[a] for a in op.attrs.get("_fn_attrs", ())}
    try:
        with torch.no_grad():
            out = op.fn(*ins, **kwargs)
    except Exception as e:
        if isinstance(e, NotImplementedError) or \
                _DATA_DEPENDENT.search(str(e)):
            return
        if re.search(rf"(?<!\d){_DYN_SENTINEL}(?!\d)", str(e)):
            # the mismatch involves the symbolic-dim stand-in, not a
            # build bug (a symbolic batch meeting a concrete one
            # broadcasts fine at run time)
            return
        if flags.get_flag("debug_fallback"):
            raise EnforceError(
                f"shape inference failed for op {op.type!r} "
                f"(inputs {[tuple(i.shape) for i in ins]}): {e}") from e
        warnings.warn(
            f"shape inference skipped for op {op.type!r}: {e} — likely a "
            "build-time shape bug (set debug_fallback=True to raise here)")
        return
    outs = (out,) if not isinstance(out, (tuple, list)) else out
    if len(outs) != len(out_vars):
        return
    for v, o in zip(out_vars, outs):
        if v is None or v.shape is not None or not isinstance(o, torch.Tensor):
            continue
        v.shape = tuple(-1 if s == _DYN_SENTINEL else s for s in o.shape)
        v.dtype = dtype_utils.normalize_dtype(o.dtype)


# -- default programs & guards ------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(p: Program) -> Program:
    global _main_program
    old, _main_program = _main_program, p
    return old


def switch_startup_program(p: Program) -> Program:
    global _startup_program
    old, _startup_program = _startup_program, p
    return old


@contextlib.contextmanager
def program_guard(main_program: Program,
                  startup_program: Optional[Program] = None):
    old_main = switch_main_program(main_program)
    old_start = (switch_startup_program(startup_program)
                 if startup_program is not None else None)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_start is not None:
            switch_startup_program(old_start)
