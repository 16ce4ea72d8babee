"""Control flow (counterpart of paddle_tpu/layers/control_flow.py;
reference: python/paddle/fluid/layers/control_flow.py While:658,
Switch:1286, StaticRNN:433, DynamicRNN:1542, over interpreter ops that
run sub-blocks in step scopes: operators/while_op.cc,
conditional_block_op.cc, recurrent_op.cc).

The Python API captures a sub-block of ops, as in the JAX package, so
programs stay data and clone. At block exit the sub-block becomes ONE
composite op of the parent block whose fn runs ``run_program_ops`` over
the sub-ops: loop-carried variables are the sub-block's writes of names
that exist outside it, closure inputs its other outside reads.

Where the JAX package compiles ``lax.scan``, ``lax.while_loop`` and
``lax.cond``, the port runs eager torch:

* ``StaticRNN``/``DynamicRNN`` walk the padded time axis
  (``core.scan``): the trip count is a shape, so they capture as CUDA
  graphs;
* ``Switch`` runs every case and selects with ``torch.where``, as the
  JAX package's nested selects: no host read, it captures;
* ``While`` and ``ConditionalBlock`` read their condition on the host
  each time (a device value decides how much work there is). Their ops
  carry the ``_host_sync`` attr: ``Executor.run_steps`` and
  ``run_graph`` refuse a program holding one on a card with
  :class:`~paddle_tpu_torch.core.enforce.GraphCaptureError` naming it,
  before any capture starts; ``Executor.run`` runs them eagerly. So
  does ``Print``.

Tensor arrays are preallocated rings of ``max_len`` slots (a
``{"buf", "len"}`` pair of tensors), read and written at clamped
indices, as the JAX package's: fixed shapes, no host read.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core import flags as _flags
from ..core.enforce import GraphCaptureError, enforce
from ..core.program import Variable, default_main_program
from ..core.scan import scan
from ..layer_helper import LayerHelper


def _device_of(args):
    """The device of the first tensor among ``args`` (the sub-block's
    constants are made there)."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
        if isinstance(a, dict):
            return a["buf"].device
    return None


def _host_bool(v: torch.Tensor, op_type: str) -> bool:
    """A scalar condition read on the host; under CUDA graph capture a
    typed error naming the op (the read would end the capture)."""
    if v.is_cuda and torch.cuda.is_current_stream_capturing():
        raise GraphCaptureError(
            "op %r reads its condition on the host each run and cannot be "
            "captured as a CUDA graph; run the program with Executor.run"
            % op_type)
    return bool(v.reshape(()).item())


def _run_sub(ops, env, device):
    from ..executor import run_program_ops

    return run_program_ops(ops, env, device=device)


# -- comparison ops -----------------------------------------------------------

def _compare(name, tfn, x, y):
    helper = LayerHelper(name)
    out = helper.create_tmp_variable(np.bool_)
    helper.append_op(type=name, inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]}, fn=tfn)
    out.shape = x.shape
    return out


def less_than(x, y, cond=None):
    out = _compare("less_than", torch.lt, x, y)
    if cond is not None:
        from .tensor import assign

        return assign(out, cond)
    return out


def less_equal(x, y):
    return _compare("less_equal", torch.le, x, y)


def greater_than(x, y):
    return _compare("greater_than", torch.gt, x, y)


def greater_equal(x, y):
    return _compare("greater_equal", torch.ge, x, y)


def equal(x, y, cond=None):
    out = _compare("equal", torch.eq, x, y)
    if cond is not None:
        from .tensor import assign

        return assign(out, cond)
    return out


def not_equal(x, y):
    return _compare("not_equal", torch.ne, x, y)


def logical_and(x, y):
    return _compare("logical_and", torch.logical_and, x, y)


def logical_or(x, y):
    return _compare("logical_or", torch.logical_or, x, y)


def logical_not(x):
    helper = LayerHelper("logical_not")
    out = helper.create_tmp_variable(np.bool_)
    helper.append_op(type="logical_not", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, fn=torch.logical_not)
    out.shape = x.shape
    return out


# -- sub-block capture --------------------------------------------------------

class _CapturedBlock:
    """The ops of a captured sub-block and their data-flow summary."""

    def __init__(self, block, outer_names):
        self.ops = list(block.ops)
        written, read, produced = [], [], set()
        for op in self.ops:
            for n in op.input_arg_names:
                if n not in produced and n not in read:
                    read.append(n)
            for n in op.output_arg_names:
                produced.add(n)
                if n not in written:
                    written.append(n)
        # loop state: written names that also exist outside the block
        self.state = [n for n in written if n in outer_names]
        # closure inputs: read, not state, defined outside
        self.external = [n for n in read
                         if n not in self.state and n in outer_names]
        self.written = written


def _outer_names_excluding(program, blk) -> set:
    """Names visible outside the captured block, taken at block exit so
    that parameters a layer made in the global block count."""
    names = set()
    for b in program.blocks:
        if b is not blk:
            names.update(b.vars)
    return names


class _BlockGuard:
    """Opens a sub-block on enter; at a clean exit rolls back and hands
    the captured block to ``finalize``."""

    def __init__(self, finalize):
        self.finalize = finalize

    def __enter__(self):
        default_main_program()._create_block()
        return self

    def __exit__(self, exc_type, *a):
        prog = default_main_program()
        blk = prog.current_block()
        prog._rollback()
        if exc_type is None:
            self.finalize(_CapturedBlock(
                blk, _outer_names_excluding(prog, blk)))
        return False


class While:
    """``with While(cond).block(): ...`` — the block must re-assign the
    condition; every outside variable it assigns is loop-carried state.
    The loop reads the condition on the host before each trip."""

    def __init__(self, cond: Variable, name: Optional[str] = None):
        enforce(np.dtype(cond.dtype) == np.bool_,
                "While condition must be a bool variable")
        self.cond = cond
        self.helper = LayerHelper(name or "while")

    def block(self):
        return _BlockGuard(self._finalize)

    def _finalize(self, cap: _CapturedBlock):
        cond_name = self.cond.name
        enforce(cond_name in cap.state,
                "While block must re-assign the condition variable %r"
                % cond_name)
        state_names, ext_names = list(cap.state), list(cap.external)
        sub_ops = cap.ops

        def fn(*args):
            device = _device_of(args)
            ext = dict(zip(ext_names, args[:len(ext_names)]))
            st = dict(zip(state_names, args[len(ext_names):]))
            while _host_bool(st[cond_name], "while"):
                env = dict(ext)
                env.update(st)
                env = _run_sub(sub_ops, env, device)
                st = {n: env[n] for n in state_names}
            return tuple(st[n] for n in state_names)

        self.helper.append_op(
            type="while", inputs={"X": ext_names + state_names},
            outputs={"Out": state_names},
            attrs={"sub_block_ops": len(sub_ops), "_host_sync": True},
            fn=fn)


class Switch:
    """``with Switch() as switch:`` then ``with switch.case(cond):`` /
    ``with switch.default():`` blocks assigning the same outer
    variables. Every case runs; the first true case's values are
    selected with ``torch.where``."""

    def __init__(self, name: Optional[str] = None):
        self.helper = LayerHelper(name or "switch")
        self.cases = []          # (cond_name or None, _CapturedBlock)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is None:
            self._finalize()
        return False

    def case(self, condition: Variable):
        return _BlockGuard(lambda cap: self.cases.append(
            (condition.name, cap)))

    def default(self):
        return _BlockGuard(lambda cap: self.cases.append((None, cap)))

    def _finalize(self):
        enforce(self.cases, "Switch with no cases")
        written = []
        for _, cap in self.cases:
            for n in cap.state:
                if n not in written:
                    written.append(n)
        ext, conds = [], []
        for cond_name, cap in self.cases:
            if cond_name is not None and cond_name not in conds:
                conds.append(cond_name)
            for n in cap.external:
                if n not in ext and n not in written:
                    ext.append(n)
        cases = self.cases

        def fn(*args):
            device = _device_of(args)
            env0 = dict(zip(conds + ext + written, args))
            out = {n: env0[n] for n in written}
            taken = torch.zeros((), dtype=torch.bool, device=device)
            for cond_name, cap in cases:
                env = _run_sub(cap.ops, dict(env0), device)
                if cond_name is None:
                    pred = ~taken
                else:
                    pred = env0[cond_name].reshape(()).to(torch.bool) & ~taken
                for n in written:
                    if n in cap.written:
                        out[n] = torch.where(pred, env[n], out[n])
                taken = taken | pred
            return tuple(out[n] for n in written)

        self.helper.append_op(type="switch",
                              inputs={"X": conds + ext + written},
                              outputs={"Out": written}, fn=fn)


class StaticRNN:
    """A step block over the time axis of its step inputs, compiled to
    one op that walks it (``core.scan``)::

        rnn = StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)          # x: [B, T, D] -> x_t: [B, D]
            h = rnn.memory(init=h0)          # loop-carried
            nh = some_layers(x_t, h)
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        out, = rnn()                         # [B, T, H]
    """

    def __init__(self, name: Optional[str] = None):
        self.helper = LayerHelper(name or "static_rnn")
        self._step_inputs = []       # (placeholder_name, source_name)
        self._memories = []          # (mem_name, init_name)
        self._mem_updates = {}       # mem_name -> new_name
        self._step_outputs = []      # step-local names
        self._outputs: List[Variable] = []
        self._cap: Optional[_CapturedBlock] = None

    def step(self):
        return _BlockGuard(self._close)

    def step_input(self, x: Variable) -> Variable:
        blk = default_main_program().current_block()
        v = blk.create_var(
            name=self.helper.unique_out("rnn_step_in"),
            shape=(x.shape[0],) + tuple(x.shape[2:])
            if x.shape is not None else None,
            dtype=x.dtype)
        self._step_inputs.append((v.name, x.name))
        return v

    def memory(self, init: Variable) -> Variable:
        blk = default_main_program().current_block()
        v = blk.create_var(name=self.helper.unique_out("rnn_mem"),
                           shape=init.shape, dtype=init.dtype)
        self._memories.append((v.name, init.name))
        return v

    def update_memory(self, mem: Variable, new: Variable) -> None:
        self._mem_updates[mem.name] = new.name

    def step_output(self, out: Variable) -> None:
        self._step_outputs.append(out.name)

    output = step_output

    def _close(self, cap: _CapturedBlock):
        # placeholders and memories are block-local
        managed = {p for p, _ in self._step_inputs} | \
                  {m for m, _ in self._memories}
        cap.external = [n for n in cap.external if n not in managed]
        self._finalize(cap)

    def _parts(self, cap):
        enforce(self._step_inputs or self._memories,
                "StaticRNN needs at least one step_input or memory")
        for mem, _ in self._memories:
            enforce(mem in self._mem_updates,
                    "memory %r never updated (update_memory missing)" % mem)
        self._cap = cap
        self._outputs = [self.helper.create_tmp_variable(np.float32)
                         for _ in self._step_outputs]
        return ([s for _, s in self._step_inputs],
                [i for _, i in self._memories],
                [p for p, _ in self._step_inputs],
                [m for m, _ in self._memories],
                [self._mem_updates[m] for m, _ in self._memories],
                list(self._step_outputs), list(cap.external), cap.ops)

    def _finalize(self, cap: _CapturedBlock):
        (in_names, init_names, placeholders, mem_names, new_names,
         out_names, ext, sub_ops) = self._parts(cap)
        n_in, n_init = len(in_names), len(init_names)

        def fn(*args):
            device = _device_of(args)
            xs = tuple(x.transpose(0, 1) for x in args[:n_in])
            ext_vals = dict(zip(ext, args[n_in + n_init:]))

            def body(carry, *x_t):
                env = dict(ext_vals)
                env.update(zip(mem_names, carry))
                env.update(zip(placeholders, x_t))
                env = _run_sub(sub_ops, env, device)
                return (tuple(env[n] for n in new_names),
                        tuple(env[n] for n in out_names))

            _, ys = scan(body, tuple(args[n_in:n_in + n_init]), xs)
            return tuple(y.transpose(0, 1) for y in ys)

        self.helper.append_op(
            type="static_rnn", inputs={"X": in_names + init_names + ext},
            outputs={"Out": [o.name for o in self._outputs]}, fn=fn)

    def __call__(self):
        enforce(self._cap is not None,
                "StaticRNN used before its step block closed")
        return self._outputs


class DynamicRNN(StaticRNN):
    """A StaticRNN over variable-length sequences: each step input's
    ``@LEN`` companion masks the memory updates (a finished sequence's
    memory is frozen) and zeroes the outputs past each length."""

    def block(self):
        return self.step()

    def _finalize(self, cap: _CapturedBlock):
        from .sequence import length_var_of

        len_var = None
        for _, src in self._step_inputs:
            v = default_main_program().current_block() \
                ._find_var_recursive(src)
            lv = length_var_of(v) if v is not None else None
            if lv is not None:
                len_var = lv
                break
        if len_var is None:
            return super()._finalize(cap)
        (in_names, init_names, placeholders, mem_names, new_names,
         out_names, ext, sub_ops) = self._parts(cap)
        n_in, n_init = len(in_names), len(init_names)

        def fn(lens, *args):
            device = _device_of(args)
            xs = tuple(x.transpose(0, 1) for x in args[:n_in])
            ext_vals = dict(zip(ext, args[n_in + n_init:]))
            T = xs[0].shape[0]
            valid_t = (torch.arange(T, device=device)[:, None]
                       < lens.to(torch.int64).reshape(-1)[None, :])

            def body(carry, valid, *x_t):
                env = dict(ext_vals)
                env.update(zip(mem_names, carry))
                env.update(zip(placeholders, x_t))
                env = _run_sub(sub_ops, env, device)

                def vmask(v):
                    return valid.reshape((valid.shape[0],)
                                         + (1,) * (v.dim() - 1))

                new = tuple(torch.where(vmask(env[n]), env[n], old)
                            for old, n in zip(carry, new_names))
                ys = tuple(torch.where(vmask(env[n]), env[n], torch.zeros(
                    (), dtype=env[n].dtype, device=device))
                    for n in out_names)
                return new, ys

            _, ys = scan(body, tuple(args[n_in:n_in + n_init]),
                         (valid_t,) + xs)
            return tuple(y.transpose(0, 1) for y in ys)

        self.helper.append_op(
            type="dynamic_rnn",
            inputs={"Len": [len_var.name],
                    "X": in_names + init_names + ext},
            outputs={"Out": [o.name for o in self._outputs]}, fn=fn)


# -- tensor arrays ------------------------------------------------------------

_flags.define_flag("tensor_array_max_len", 256,
                   "slot count preallocated for layers.create_array")

_ARRAY_EMPTY = "__empty_tensor_array__"


def create_array(dtype, max_len: Optional[int] = None):
    """An empty tensor array of ``max_len`` slots (default: the
    ``tensor_array_max_len`` flag); its buffer is made at the first
    write, so an array carried by a While needs one write before the
    loop."""
    helper = LayerHelper("create_array")
    out = helper.create_tmp_variable(dtype)
    ml = int(max_len or _flags.get_flag("tensor_array_max_len"))
    helper.append_op(type="create_array", inputs={},
                     outputs={"Out": [out.name]},
                     attrs={"max_len": ml, "_non_tensor_out": True},
                     fn=lambda: _ARRAY_EMPTY)
    out._array_max_len = ml
    return out


def _index(iv: torch.Tensor, ml: int) -> torch.Tensor:
    """A scalar index clamped to [0, ml), as XLA clamps dynamic
    indices; a [1] int64 tensor."""
    return torch.clamp(iv.reshape(1).to(torch.int64), 0, ml - 1)


def array_write(x, i, array=None):
    """Write ``x`` into slot ``i`` (a scalar int var); returns the
    array. A write past the last slot lands in it as NaN (float
    arrays), so ``check_nan_inf`` and any reader see the overflow."""
    if array is None:
        array = create_array(x.dtype)
    helper = LayerHelper("array_write")
    ml = getattr(array, "_array_max_len",
                 int(_flags.get_flag("tensor_array_max_len")))

    def fn(arr, xv, iv):
        if isinstance(arr, str):  # the empty marker: make the buffer
            arr = {"buf": torch.zeros((ml,) + tuple(xv.shape),
                                      dtype=xv.dtype, device=xv.device),
                   "len": torch.zeros((), dtype=torch.int32,
                                      device=xv.device)}
        iv = iv.reshape(()).to(torch.int32)
        if xv.dtype.is_floating_point:
            xv = torch.where(iv < ml, xv, torch.full(
                (), float("nan"), dtype=xv.dtype, device=xv.device))
        buf = arr["buf"].index_copy(0, _index(iv, ml), xv[None])
        return {"buf": buf, "len": torch.maximum(arr["len"], iv + 1)}

    helper.append_op(type="array_write",
                     inputs={"Array": [array.name], "X": [x.name],
                             "I": [i.name]},
                     outputs={"Out": [array.name]},
                     attrs={"_non_tensor_out": True}, fn=fn)
    return array


def array_read(array, i):
    """Slot ``i`` of a tensor array."""
    helper = LayerHelper("array_read")
    out = helper.create_tmp_variable(array.dtype)

    def fn(arr, iv):
        enforce(not isinstance(arr, str),
                "array_read from an empty tensor array — array_write "
                "first (inside While: once before the loop, to fix the "
                "slot shape)")
        buf = arr["buf"]
        return buf.index_select(0, _index(iv, buf.shape[0]))[0]

    helper.append_op(type="array_read",
                     inputs={"Array": [array.name], "I": [i.name]},
                     outputs={"Out": [out.name]}, fn=fn)
    return out


def array_length(array):
    """The high-water length of a tensor array (int64 scalar)."""
    helper = LayerHelper("array_length")
    out = helper.create_tmp_variable(np.int64)

    def fn(arr):
        if isinstance(arr, str):
            return torch.zeros((), dtype=torch.int64)
        return arr["len"].to(torch.int64)

    helper.append_op(type="array_length", inputs={"Array": [array.name]},
                     outputs={"Out": [out.name]}, fn=fn)
    out.shape = ()
    return out


# -- rank tables and reordering -----------------------------------------------

def lod_rank_table(x, level: int = 0):
    """Batch rows sorted by descending length (stable): a ``{"idx",
    "len"}`` pair (reference: framework/lod_rank_table.h)."""
    from .sequence import _require_len

    helper = LayerHelper("lod_rank_table")
    lv = _require_len(x, None)
    out = helper.create_tmp_variable(np.int32)

    def fn(lens):
        lens = lens.to(torch.int32).reshape(-1)
        order = torch.argsort(-lens, stable=True)
        return {"idx": order, "len": lens[order]}

    helper.append_op(type="lod_rank_table", inputs={"Length": [lv.name]},
                     outputs={"Out": [out.name]},
                     attrs={"level": level, "_non_tensor_out": True}, fn=fn)
    return out


def max_sequence_len(rank_table):
    helper = LayerHelper("max_sequence_len")
    out = helper.create_tmp_variable(np.int64)
    helper.append_op(type="max_sequence_len",
                     inputs={"RankTable": [rank_table.name]},
                     outputs={"Out": [out.name]},
                     fn=lambda t: torch.max(t["len"]).to(torch.int64))
    out.shape = ()
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    """Batch rows permuted into the rank table's order (reference:
    operators/reorder_lod_tensor_by_rank_op.cc)."""
    helper = LayerHelper("reorder_lod_tensor_by_rank")
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="reorder_lod_tensor_by_rank",
                     inputs={"X": [x.name], "RankTable": [rank_table.name]},
                     outputs={"Out": [out.name]},
                     fn=lambda xv, t: xv[t["idx"]])
    out.shape = x.shape
    return out


def lod_tensor_to_array(x, table):
    """The padded time axis unstacked into a tensor array, rows in the
    rank table's order (reference: operators/lod_tensor_to_array_op.cc)."""
    helper = LayerHelper("lod_tensor_to_array")
    arr = create_array(x.dtype, max_len=(
        x.shape[1] if x.shape is not None and x.shape[1] != -1 else None))

    def fn(xv, t):
        buf = xv[t["idx"]].transpose(0, 1)          # [T, B, ...]
        return {"buf": buf, "len": torch.full((), buf.shape[0],
                                              dtype=torch.int32,
                                              device=buf.device)}

    helper.append_op(type="lod_tensor_to_array",
                     inputs={"X": [x.name], "RankTable": [table.name]},
                     outputs={"Out": [arr.name]},
                     attrs={"_non_tensor_out": True}, fn=fn)
    return arr


def array_to_lod_tensor(x, table):
    """The inverse of lod_tensor_to_array: stack the time slices and
    undo the rank order (reference: operators/array_to_lod_tensor_op.cc)."""
    helper = LayerHelper("array_to_lod_tensor")
    out = helper.create_tmp_variable(x.dtype)

    def fn(arr, t):
        enforce(not isinstance(arr, str),
                "array_to_lod_tensor on empty tensor array")
        return arr["buf"].transpose(0, 1)[torch.argsort(t["idx"])]

    helper.append_op(type="array_to_lod_tensor",
                     inputs={"Array": [x.name], "RankTable": [table.name]},
                     outputs={"Out": [out.name]}, fn=fn)
    return out


def split_lod_tensor(input, mask, level: int = 0):
    """Rows split by a [B, 1] bool mask into (true part, false part),
    each the full batch extent with its rows compacted to the front
    (reference: operators/split_lod_tensor_op.cc); merge_lod_tensor
    restores the order."""
    helper = LayerHelper("split_lod_tensor")
    out_true = helper.create_tmp_variable(input.dtype)
    out_false = helper.create_tmp_variable(input.dtype)
    nt = helper.create_tmp_variable(np.int32)
    nf = helper.create_tmp_variable(np.int32)

    def fn(xv, m):
        m = m.reshape(-1).to(torch.bool)
        mi = m.to(torch.int8)
        return (xv[torch.argsort(1 - mi, stable=True)],
                xv[torch.argsort(mi, stable=True)],
                m.sum().to(torch.int32), (~m).sum().to(torch.int32))

    helper.append_op(type="split_lod_tensor",
                     inputs={"X": [input.name], "Mask": [mask.name]},
                     outputs={"OutTrue": [out_true.name],
                              "OutFalse": [out_false.name],
                              "NumTrue": [nt.name], "NumFalse": [nf.name]},
                     attrs={"level": level}, fn=fn)
    out_true.shape = input.shape
    out_false.shape = input.shape
    return out_true, out_false


def merge_lod_tensor(in_true, in_false, x, mask, level: int = 0):
    """Merge split_lod_tensor's parts back into the rows' order
    (reference: operators/merge_lod_tensor_op.cc)."""
    helper = LayerHelper("merge_lod_tensor")
    out = helper.create_tmp_variable(in_true.dtype)

    def fn(tv, fv, xv, m):
        m = m.reshape(-1).to(torch.bool)
        idx = torch.where(m, torch.cumsum(m.to(torch.int64), 0) - 1,
                          torch.cumsum((~m).to(torch.int64), 0) - 1)
        return torch.where(m.reshape((-1,) + (1,) * (tv.dim() - 1)),
                           tv[idx], fv[idx])

    helper.append_op(type="merge_lod_tensor",
                     inputs={"InTrue": [in_true.name],
                             "InFalse": [in_false.name],
                             "X": [x.name], "Mask": [mask.name]},
                     outputs={"Out": [out.name]}, attrs={"level": level},
                     fn=fn)
    out.shape = in_true.shape
    return out


def shrink_memory(x, i, table):
    """The identity: the padded design freezes finished rows by masking
    instead of shrinking the state (reference:
    operators/shrink_rnn_memory_op.cc)."""
    helper = LayerHelper("shrink_memory")
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="shrink_memory",
                     inputs={"X": [x.name], "I": [i.name],
                             "RankTable": [table.name]},
                     outputs={"Out": [out.name]},
                     fn=lambda xv, iv, t: xv)
    out.shape = x.shape
    return out


# -- IfElse / ConditionalBlock / Print / is_empty / ParallelDo ----------------

def is_empty(x, cond=None):
    """Whether ``x`` has no elements (a shape fact: no device read)."""
    helper = LayerHelper("is_empty")
    out = cond if cond is not None else helper.create_tmp_variable(np.bool_)
    helper.append_op(type="is_empty", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     fn=lambda v: torch.full((), v.numel() == 0,
                                             dtype=torch.bool,
                                             device=v.device))
    out.shape = ()
    return out


def Print(input, first_n: int = -1, message: Optional[str] = None,
          summarize: int = -1, print_tensor_name: bool = True,
          print_tensor_type: bool = True, print_tensor_shape: bool = True,
          print_tensor_lod: bool = True, print_phase: str = "both"):
    """Print a tensor each time the op runs, and pass it on (reference:
    operators/print_op.cc). The value is read on the host, so the op
    carries ``_host_sync`` (no CUDA graph capture)."""
    helper = LayerHelper("print")
    out = helper.create_tmp_variable(input.dtype)
    msg = message or ""
    name = input.name if print_tensor_name else ""

    def fn(v):
        if v.device.type != "meta":
            shape = str(tuple(v.shape)) if print_tensor_shape else ""
            print("%s %s shape=%s: %s" % (msg, name, shape,
                                          v.detach().cpu().numpy()),
                  flush=True)
        return v

    helper.append_op(type="print", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"message": msg, "_host_sync": True}, fn=fn)
    out.shape = input.shape
    return out


class ConditionalBlock:
    """Run a captured sub-block only when a scalar bool condition holds
    (reference: operators/conditional_block_op.cc); the condition is
    read on the host, and a false one passes the state through."""

    def __init__(self, inputs: Sequence[Variable], name: Optional[str] = None):
        enforce(len(inputs) >= 1, "ConditionalBlock needs a condition var")
        self.cond = inputs[0]
        self.helper = LayerHelper(name or "conditional_block")

    def block(self):
        return _BlockGuard(self._finalize)

    def _finalize(self, cap: _CapturedBlock):
        state_names, ext_names = list(cap.state), list(cap.external)
        sub_ops = cap.ops

        def fn(cond_v, *args):
            if not _host_bool(cond_v, "conditional_block"):
                return tuple(args[len(ext_names):])
            env = dict(zip(ext_names + state_names, args))
            env = _run_sub(sub_ops, env, _device_of((cond_v,) + args))
            return tuple(env[n] for n in state_names)

        self.helper.append_op(
            type="conditional_block",
            inputs={"Cond": [self.cond.name], "X": ext_names + state_names},
            outputs={"Out": state_names},
            attrs={"sub_block_ops": len(sub_ops), "_host_sync": True},
            fn=fn)


class IfElse:
    """Per-row two-branch computation merged by a [B, 1] bool condition
    (reference: layers/control_flow.py IfElse over split/merge_lod_tensor).
    Both branches run on the full batch and each ``output`` pair merges
    row by row with ``torch.where``, as in the JAX package::

        ie = IfElse(cond)
        with ie.true_block():  ie.output(expr_t)
        with ie.false_block(): ie.output(expr_f)
        merged, = ie()
    """

    def __init__(self, cond: Variable, name: Optional[str] = None):
        self.cond = cond
        self.helper = LayerHelper(name or "ifelse")
        self._outs = {True: [], False: []}
        self._phase = None

    def true_block(self):
        return _IfElseGuard(self, True)

    def false_block(self):
        return _IfElseGuard(self, False)

    def input(self, x):
        """A branch's view of ``x``: the whole batch."""
        return x

    def output(self, *outs):
        enforce(self._phase is not None,
                "IfElse.output() must be called inside a branch block")
        self._outs[self._phase].extend(outs)

    def __call__(self):
        t, f = self._outs[True], self._outs[False]
        enforce(len(t) == len(f) and t,
                "IfElse: both branches must declare the same number of "
                "outputs via output()")
        merged = []
        for tv, fv in zip(t, f):
            out = self.helper.create_tmp_variable(tv.dtype)

            def fn(c, a, b):
                c = c.reshape((-1,) + (1,) * (a.dim() - 1)).to(torch.bool)
                return torch.where(c, a, b)

            self.helper.append_op(
                type="ifelse_merge",
                inputs={"Cond": [self.cond.name], "True": [tv.name],
                        "False": [fv.name]},
                outputs={"Out": [out.name]}, fn=fn)
            out.shape = tv.shape
            merged.append(out)
        return merged


class _IfElseGuard:
    def __init__(self, ie: IfElse, phase: bool):
        self.ie = ie
        self.phase = phase

    def __enter__(self):
        enforce(self.ie._phase is None, "IfElse blocks cannot nest")
        self.ie._phase = self.phase
        return self

    def __exit__(self, *a):
        self.ie._phase = None
        return False


class ParallelDo:
    """The reference's pre-ParallelExecutor data-parallel block
    (operators/parallel_do_op.cc). Its block is inlined unchanged, as in
    the JAX package, where the program is already data-parallel over a
    mesh (multi-GPU is ROADMAP Queue A 9)."""

    def __init__(self, places=None, use_nccl: bool = False,
                 name: Optional[str] = None):
        del places, use_nccl
        self._written = []

    def do(self):
        return _ParallelDoGuard()

    def read_input(self, x):
        return x

    def write_output(self, x):
        self._written.append(x)

    def __call__(self):
        return list(self._written)


class _ParallelDoGuard:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


__all__ = ["While", "Switch", "StaticRNN", "DynamicRNN", "less_than",
           "less_equal", "greater_than", "greater_equal", "equal",
           "not_equal", "logical_and", "logical_or", "logical_not",
           "create_array", "array_write", "array_read", "array_length",
           "lod_rank_table", "max_sequence_len",
           "reorder_lod_tensor_by_rank", "lod_tensor_to_array",
           "array_to_lod_tensor", "split_lod_tensor", "merge_lod_tensor",
           "shrink_memory", "is_empty", "Print", "IfElse",
           "ConditionalBlock", "ParallelDo"]
