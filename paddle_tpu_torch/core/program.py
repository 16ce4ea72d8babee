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
        # name of the companion per-example length var of a sequence
        # (``<data>@LEN``): carried through the ops that keep the
        # [batch, time, ...] lead (Block._propagate_seq_length)
        self.seq_length_name: Optional[str] = None
        # a 2-level sequence's OUTER companion ([B] inner-sequence
        # counts, ``<data>@LEN0``); seq_length_name then names the
        # innermost one ([B, S])
        self.seq_outer_length_name: Optional[str] = None

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
        # set by embedding(is_sparse=True): backward would emit the
        # (rows, values) pair instead of a dense table gradient
        self.sparse_grad = False


class Deferred:
    """An op output computed only when something reads it: a later op,
    a fetch or a persistable write-back (the executor resolves it). An
    op returns one for a costly output that is usually dead, which XLA
    would drop by itself — the ``Softmax`` of
    ``softmax_with_cross_entropy`` is ``[.., V]``."""

    __slots__ = ("fn",)

    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn

    def resolve(self):
        return self.fn()


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
        self._propagate_seq_length(op)
        self.program._bump()
        return op

    def _propagate_seq_length(self, op: Operator) -> None:
        """Outputs inherit the length companion of their inputs when all
        sequence inputs share one (the LoD propagation of the
        reference's per-op InferShape, framework/shape_inference.h); an
        output that already names one keeps it."""
        ins = [self._find_var_recursive(n) for n in op.input_arg_names]
        lens = {v.seq_length_name for v in ins
                if v is not None and v.seq_length_name}
        if len(lens) != 1:
            return
        ln = next(iter(lens))
        outer = {v.seq_outer_length_name for v in ins
                 if v is not None and v.seq_outer_length_name}
        on = next(iter(outer)) if len(outer) == 1 else None
        for name in op.output_arg_names:
            v = self._find_var_recursive(name)
            if v is not None and v.seq_length_name is None:
                v.seq_length_name = ln
                if on is not None and v.seq_outer_length_name is None:
                    v.seq_outer_length_name = on

    def prepend_op(self, type: str, inputs=None, outputs=None, attrs=None,
                   fn: Optional[Callable] = None) -> Operator:
        op = Operator(self, type, inputs or {}, outputs or {}, attrs, fn)
        self.ops.insert(0, op)
        self.program._bump()
        return op

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def __repr__(self):
        return f"Block(idx={self.idx}, ops={len(self.ops)}, vars={len(self.vars)})"


class Program:
    """The program: a list of blocks (the layers build the global block
    only; ``_create_block`` adds a sub-block)."""

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

    def _create_block(self, parent_idx: Optional[int] = None) -> Block:
        """A new sub-block under ``parent_idx`` (default: the current
        block), made current; the sub-block's names resolve through its
        ancestors (``Block._find_var_recursive``)."""
        parent = (self._current_block_idx if parent_idx is None
                  else parent_idx)
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self._current_block_idx = b.idx
        return b

    def _rollback(self) -> None:
        self._current_block_idx = self.current_block().parent_idx

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
        if hasattr(self, "_flat_state_views"):
            # fuse_optimizer_state's view map: a clone reads its
            # parameters from the same flat buffers
            p._flat_state_views = self._flat_state_views
        if hasattr(self, "_amp_stamp"):
            # an AMP-rewritten program's clones keep the rewritten ops,
            # and with them the stamp (amp/rewrite.py)
            p._amp_stamp = self._amp_stamp
        if hasattr(self, "_sharding_plan"):
            # a sharded program's clones keep the injected constraint
            # ops and param annotations, so they keep the plan (the
            # executor's sharded dispatch) and its compile-cache stamp
            p._sharding_plan = self._sharding_plan
            p._sharding_stamp = self._sharding_stamp
        if hasattr(self, "_passes_stamp"):
            # so do a pass pipeline's (passes/manager.py): a pruned
            # export of an int8 program keys the compile cache by it
            p._passes_stamp = self._passes_stamp
        return p

    def prune(self, targets: Sequence[str]) -> "Program":
        """A clone keeping only the ops needed to produce ``targets``
        (names) and the vars those ops and targets name, as the JAX
        package's ``Program.prune`` (reference: framework/prune.h;
        io.py:512 prunes for inference export). The clone keeps the
        flat-state view map and gets a version of its own."""
        p = self.clone()
        gb = p.global_block()
        needed = set(targets)
        kept: List[Operator] = []
        for op in reversed(gb.ops):
            if set(op.output_arg_names) & needed or op.type == "fetch":
                kept.append(op)
                needed.update(op.input_arg_names)
        gb.ops = list(reversed(kept))
        referenced = set(targets)
        for op in gb.ops:
            referenced.update(op.input_arg_names)
            referenced.update(op.output_arg_names)
        gb.vars = {n: v for n, v in gb.vars.items() if n in referenced}
        p._bump()
        return p

    def validate(self, feed=None, fetch_list=None,
                 raise_on_error: bool = True, with_comm: bool = False):
        """Run the static program verifier (paddle_tpu_torch.analysis)
        over this program: graph validation, shape/dtype inference,
        recompile lint; ``with_comm=True`` adds the SPMD communication
        lints for plan-stamped programs. Returns the AnalysisReport; with
        ``raise_on_error`` (the default) error-severity diagnostics
        raise EnforceError first — the build-time equivalent of the
        reference's InferShape/InferVarType enforcement over the
        ProgramDesc."""
        from .. import analysis

        report = analysis.check_program(self, feed=feed or (),
                                        fetch_list=fetch_list or (),
                                        with_comm=with_comm)
        if raise_on_error and not report.ok:
            raise EnforceError(str(report))
        return report

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
    if op.fn is None or op.attrs.get("_non_tensor_out"):
        # an op that declares a non-tensor product (a tensor array, a
        # rank table) has nothing for shape inference to check
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
        if any(getattr(block._find_var_recursive(n), "lod_level", 0)
               for n in op.input_arg_names):
            # a sequence input may be declared with the reference's
            # per-step shape (the time axis implicit, filled by the
            # DataFeeder's padding): its declared rank is not its run-time
            # rank, and abstract evaluation cannot be trusted either way
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
        if isinstance(o, Deferred):
            with torch.no_grad():
                o = o.resolve()
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


def get_var(name: str, program: Program = None) -> Variable:
    """A variable of a program's global block by name (default: the
    default main program)."""
    if program is None:
        program = default_main_program()
    enforce(isinstance(name, str), "name must be str")
    enforce(isinstance(program, Program), "program must be a Program")
    return program.global_block().var(name)


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
