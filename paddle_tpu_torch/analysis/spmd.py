"""SPMD spec propagation: the abstract interpreter over PartitionSpecs
(counterpart of paddle_tpu/analysis/spmd.py, the same rules and events).

Fluid's DistributeTranspiler rewrote the ProgramDesc to CONTAIN its
send/recv/all-reduce ops, so communication was statically visible. A
plan-stamped program (``sharding.shard_program``) carries only layout
annotations; this module restores the static view: it walks every block
in the ``infer.py`` mold (registry rule first, conservative unknown-spec
fallback, never a false positive), infers the per-op input/output
layout from the plan's parameter/constraint annotations, and predicts
the collectives an SPMD partitioner must insert for that layout — the
JAX package's, which hands the program to XLA's — as
:class:`CommEvent` records:

  * **all-gather** — a layout transition that widens a tensor: a
    ``sharding_constraint`` dropping axes the inferred layout carries,
    or a dot operand whose contracting shard cannot ride the
    contraction (blocked by the other operand's layout);
  * **all-reduce** — a dot contraction or reduction over sharded dims
    (one instruction per op, however many mesh axes it spans — the
    partitioner merges them into one replica-group product);
  * **reduce-scatter** — ZeRO gradient flows (kept in the event
    vocabulary; forward programs never predict one);
  * **reshard** — an equal-width layout move (collective-permute /
    slice exchange): counted separately, never as a gather.

The contraction rule: with ``A_l``/``A_r`` the axis sets on the
contracting dims, shared axes contract in place; an exclusive
contracting axis rides along unless it is *blocked* (it also shards a
non-contracting dim of the other operand); the union ``T`` of surviving
axes takes ONE all-reduce; each side reshards its contracting dims onto
``T`` — strictly narrower is an all-gather, equal-width a reshard,
wider is a free slice. When everything is blocked but a mesh axis is
unused by both operands, the partitioner permutes the blocked shard
onto that free axis instead of gathering (one reshard + one all-reduce
over the free axis).

The port's runtime does not partition a program this way: each rank
runs its block with the explicit collectives of ``sharding/spmd.py``
(parameter gathers, batch sums, averaged gradients, the tensor-parallel
fc's sum). The prediction is a reading of the program and its plan,
held to the JAX package's event for event; where the two schemes agree
(a row-parallel fc's all-reduce) it is also held to ``comm.STATS``.

Static bytes are GLOBAL logical tensor bytes entering the collective
(the gathered result for an all-gather, the reduced value for an
all-reduce) — a size proxy, not per-link traffic; ``None`` whenever a
dim stays symbolic (honest, never faked).

Dynamic batch dims are concretized with ``batch_size`` (default: the
plan's ``batch_size_multiple()`` — the smallest batch the mesh can
split); pass the real batch for exact byte totals. The plan's mesh is
read as a shape: no live world is needed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..core import dtype_utils
from ..core.program import Block, Parameter
from .infer import _infer_op, declared_type
from .op_registry import (SignatureError, TensorType, UNKNOWN,
                          get_comm_signature, meet, shapes_compatible)


class _UnknownSpec:
    """Sentinel: this tensor's layout cannot be proven. Absorbs every
    propagation step it participates in (except scalars, which carry no
    layout)."""

    __slots__ = ()

    def __repr__(self):
        return "UNKNOWN_SPEC"


UNKNOWN_SPEC = _UnknownSpec()

# data-like mesh axes a batch feed splits over (mesh.data_sharding)
_DATA_LIKE_AXES = ("data", "dp", "fsdp")


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def spec_axes(spec) -> Tuple[str, ...]:
    """Flattened axis names of a spec, in dim order."""
    if spec is UNKNOWN_SPEC or spec is None:
        return ()
    out: List[str] = []
    for e in spec:
        out.extend(_entry_axes(e))
    return tuple(out)


def _pad(spec, rank: int) -> Tuple:
    sp = tuple(spec)
    return sp + (None,) * (rank - len(sp)) if len(sp) < rank else sp[:rank]


def _trim(entries) -> Tuple:
    out = list(entries)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _axes_prod(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.size(a)
    return n


def _nbytes(t: TensorType) -> Optional[float]:
    """Global logical bytes, None while any extent is symbolic."""
    if t.shape is None or t.dtype is None or any(d < 0 for d in t.shape):
        return None
    n = 1.0
    for d in t.shape:
        n *= d
    return n * dtype_utils.itemsize(t.dtype)


class CommEvent:
    """One predicted collective, pinned to (block, op, var) context.

    ``kind``   — all-gather | all-reduce | reduce-scatter | reshard
    ``reason`` — contraction | constraint-transition | reduction |
                 free-axis | fetch-gather | persistable-write
    ``axes``   — mesh axes the collective spans
    ``bytes``  — global logical bytes entering it (None = symbolic)
    """

    __slots__ = ("kind", "reason", "block_idx", "op_idx", "op_type",
                 "var", "axes", "bytes")

    def __init__(self, kind: str, reason: str, block_idx: int,
                 op_idx: Optional[int], op_type: Optional[str],
                 var: Optional[str], axes: Tuple[str, ...],
                 byts: Optional[float]):
        self.kind = kind
        self.reason = reason
        self.block_idx = block_idx
        self.op_idx = op_idx
        self.op_type = op_type
        self.var = var
        self.axes = tuple(axes)
        self.bytes = byts

    def __repr__(self):
        b = "?" if self.bytes is None else f"{self.bytes:.0f}"
        return (f"CommEvent({self.kind}[{self.reason}] "
                f"block {self.block_idx} op#{self.op_idx} "
                f"({self.op_type}) var {self.var!r} "
                f"axes={self.axes} bytes={b})")


class OpSpecs:
    """One op's resolved layouts plus the events it triggers."""

    __slots__ = ("block_idx", "op_idx", "op_type", "in_specs",
                 "out_specs", "events")

    def __init__(self, block_idx, op_idx, op_type, in_specs, out_specs,
                 events):
        self.block_idx = block_idx
        self.op_idx = op_idx
        self.op_type = op_type
        self.in_specs = list(in_specs)
        self.out_specs = list(out_specs)
        self.events = list(events)

    def __repr__(self):
        return (f"OpSpecs(block {self.block_idx} op#{self.op_idx} "
                f"{self.op_type}: {self.in_specs} -> {self.out_specs}, "
                f"{len(self.events)} event(s))")


class SpmdResult:
    """Outcome of one propagation sweep."""

    def __init__(self, planless: bool = False):
        self.planless = planless
        # (block_idx, var_name) -> spec tuple | UNKNOWN_SPEC
        self.specs: Dict[Tuple[int, str], object] = {}
        # (block_idx, var_name) -> inferred TensorType (feeds + op outs)
        self.types: Dict[Tuple[int, str], TensorType] = {}
        self.op_specs: List[OpSpecs] = []
        self.events: List[CommEvent] = []
        # op types whose layout effect could not be proven (unregistered
        # kind, unknown operand layout, unresolvable dims)
        self.unknowns: set = set()
        # (var, axis, dim_idx) spec entries clean_spec silently dropped
        self.indivisible: set = set()
        self.notes: List[str] = []

    @property
    def complete(self) -> bool:
        """True when every op's layout effect was proven — only then do
        predicted counts bound the compiled collective counts."""
        return not self.unknowns

    def spec_of(self, name: str, block_idx: int = 0):
        return self.specs.get((block_idx, name), UNKNOWN_SPEC)


def _transition_events(mesh, src_axes, dst_axes, reason, ctx, var,
                       byts) -> List[CommEvent]:
    """Events for resharding one tensor's axis set src -> dst: strictly
    narrower destination = all-gather, equal width = reshard, wider =
    free slice (no collective)."""
    removed = tuple(a for a in src_axes if a not in dst_axes)
    if not removed:
        return []
    added = tuple(a for a in dst_axes if a not in src_axes)
    p_rm, p_ad = _axes_prod(mesh, removed), _axes_prod(mesh, added)
    if p_rm > p_ad:
        return [CommEvent("all-gather", reason, *ctx, var, removed, byts)]
    if p_rm == p_ad:
        return [CommEvent("reshard", reason, *ctx, var, removed, byts)]
    return []


def _merge_elementwise(in_specs, in_types, out_type):
    """Right-aligned broadcast merge. Scalar operands carry no layout;
    a conflicting pair of sharded entries degrades to None (unknown) —
    the partitioner's pick is not ours to guess."""
    if out_type.shape is None:
        return None
    rank = len(out_type.shape)
    out: List[object] = [None] * rank
    for s, t in zip(in_specs, in_types):
        if t.shape is not None and len(t.shape) == 0:
            continue  # scalar: no layout to contribute
        if s is UNKNOWN_SPEC or t.shape is None:
            return None
        r = len(t.shape)
        off = rank - r
        if off < 0:
            return None
        sp = _pad(s, r)
        for j, e in enumerate(sp):
            if e is None:
                continue
            cur = out[off + j]
            if cur is None:
                out[off + j] = e
            elif _entry_axes(cur) != _entry_axes(e):
                return None  # conflicting layouts meet: degrade
    return _trim(out)


class _BlockWalker:
    """One block's propagation pass (fresh type/spec env per block, the
    infer_block convention)."""

    def __init__(self, block: Block, plan, result: SpmdResult,
                 feed_shapes: Dict[str, Sequence[int]],
                 constraint_overrides: Optional[Dict[str, Tuple]] = None):
        self.block = block
        self.plan = plan
        self.mesh = plan.mesh
        self.result = result
        self.constraint_overrides = constraint_overrides or {}
        self.tenv: Dict[str, TensorType] = {}
        self.senv: Dict[str, object] = {}
        for name, shape in feed_shapes.items():
            var = block._find_var_recursive(name)
            if var is not None:
                self.tenv[name] = TensorType(
                    shape, var.dtype if var.dtype is not None else None)

    # -- environments ---------------------------------------------------
    def type_of(self, name: str) -> TensorType:
        if name in self.tenv:
            return self.tenv[name]
        return declared_type(self.block._find_var_recursive(name))

    def spec_of(self, name: str):
        if name in self.senv:
            return self.senv[name]
        spec = self._seed_spec(name)
        self.senv[name] = spec
        return spec

    def _record_drops(self, var, name, shape):
        """Spec entries clean_spec silently drops for indivisibility
        feed the comm-indivisible-replication lint."""
        from ..sharding.rules import dropped_axes, match_partition_rules

        raw = getattr(var, "sharding_spec", None) if var is not None \
            else None
        if raw is None:
            raw = match_partition_rules(self.plan.rules, name, shape)
        if raw:
            for axis, dim_idx in dropped_axes(self.mesh, raw, shape):
                self.result.indivisible.add((name, axis, dim_idx))

    def _seed_spec(self, name: str):
        """Layout of a value with no in-block producer: params and
        persistables resolve through the plan (the executor's
        state_sharding path); batch-like feeds split their leading dim
        over the data-like axes when divisible (feed_sharding); the
        rest fall back to the plan's rule match."""
        var = self.block._find_var_recursive(name)
        if var is None:
            return UNKNOWN_SPEC
        t = self.type_of(name)
        shape = t.shape if t.shape is not None else var.shape
        if isinstance(var, Parameter) or var.persistable:
            self._record_drops(var, name, shape)
            return tuple(self.plan.spec_for(var, name, shape))
        batchlike = var.is_data or (var.shape is not None
                                    and len(var.shape) > 0
                                    and var.shape[0] == -1)
        if batchlike and shape is not None and len(shape) > 0:
            lead = int(shape[0])
            if lead == -1 or (lead > 0 and lead
                              % self.mesh.batch_size_multiple() == 0):
                axes = tuple(a for a in _DATA_LIKE_AXES
                             if self.mesh.size(a) > 1)
                if not axes:
                    return ()
                return (axes if len(axes) > 1 else axes[0],)
            return ()  # indivisible batch: the executor replicates it
        return tuple(self.plan.spec_for(var, name, shape))

    # -- per-kind propagation rules -------------------------------------
    def _apply_contraction(self, op, sig, ins_s, ins_t, outs_t, ctx,
                           events):
        if sig.contract is None or len(ins_s) < 2:
            return None
        dims = sig.contract(op, ins_t)
        if dims is None:
            return None
        ls, rs = ins_s[0], ins_s[1]
        lt, rt = ins_t[0], ins_t[1]
        if ls is UNKNOWN_SPEC or rs is UNKNOWN_SPEC \
                or lt.shape is None or rt.shape is None:
            return None
        ra, rb = len(lt.shape), len(rt.shape)
        lset = set(d % ra for d in dims[0])
        rset = set(d % rb for d in dims[1])
        lsp, rsp = _pad(ls, ra), _pad(rs, rb)
        mesh = self.mesh

        def _axes_on(sp, ds):
            out = []
            for d in sorted(ds):
                out.extend(_entry_axes(sp[d]))
            return tuple(dict.fromkeys(out))

        a_l = _axes_on(lsp, lset)
        a_r = _axes_on(rsp, rset)
        other_l = _axes_on(lsp, set(range(ra)) - lset)
        other_r = _axes_on(rsp, set(range(rb)) - rset)
        shared = tuple(a for a in a_l if a in a_r)
        blocked_l = tuple(a for a in a_l
                          if a not in shared and a in other_r)
        blocked_r = tuple(a for a in a_r
                          if a not in shared and a in other_l)
        target = list(shared)
        for a in a_l + a_r:
            if a not in target and a not in blocked_l \
                    and a not in blocked_r:
                target.append(a)

        l_names = op.input_arg_names[:2]
        out_name = op.output_arg_names[0] if op.output_arg_names else None
        out_t = outs_t[0] if outs_t else UNKNOWN
        free_handled = False
        if not target and (blocked_l or blocked_r):
            if bool(blocked_l) != bool(blocked_r):
                # exactly one side blocked, the other unsharded on its
                # contracting dims: the partitioner permutes the blocked
                # shard onto a mesh axis unused by both operands (one
                # reshard + one all-reduce) instead of gathering
                used = set(spec_axes(lsp)) | set(spec_axes(rsp))
                free = [a for a in mesh.axis_names
                        if mesh.size(a) > 1 and a not in used]
                if free:
                    target = [free[0]]
                    blocked = blocked_l or blocked_r
                    b_idx = 0 if blocked_l else 1
                    events.append(CommEvent(
                        "reshard", "free-axis", *ctx, l_names[b_idx],
                        blocked, _nbytes(ins_t[b_idx])))
                    free_handled = True
        if not free_handled:
            if not target and (blocked_l or blocked_r):
                # fully blocked with no free axis: both blocked shards
                # must gather before the dot
                for b_idx, blocked in ((0, blocked_l), (1, blocked_r)):
                    if blocked:
                        events.append(CommEvent(
                            "all-gather", "contraction", *ctx,
                            l_names[b_idx], blocked,
                            _nbytes(ins_t[b_idx])))
            else:
                for b_idx, a_x in ((0, a_l), (1, a_r)):
                    events.extend(_transition_events(
                        mesh, a_x, target, "contraction", ctx,
                        l_names[b_idx], _nbytes(ins_t[b_idx])))
        if target:
            events.append(CommEvent(
                "all-reduce", "contraction", *ctx, out_name,
                tuple(target), _nbytes(out_t)))

        # output layout: kept (non-contracting) entries, lhs-first
        l_keep = [lsp[d] for d in range(ra) if d not in lset]
        r_keep = [rsp[d] for d in range(rb) if d not in rset]
        if out_t.shape is None:
            return [UNKNOWN_SPEC]
        rank = len(out_t.shape)
        entries = None
        if len(l_keep) + len(r_keep) == rank:
            entries = l_keep + r_keep
        elif len(l_keep) + len(r_keep) > rank and ra > 2 and rb > 2:
            # batched dot: shared leading batch dims appear once
            n_shared = len(l_keep) + len(r_keep) - rank
            lead_l, lead_r = l_keep[:n_shared], r_keep[:n_shared]
            if all(_entry_axes(x) == _entry_axes(y)
                   for x, y in zip(lead_l, lead_r)):
                entries = lead_l + l_keep[n_shared:] + r_keep[n_shared:]
        if entries is None:
            return [UNKNOWN_SPEC]
        seen: set = set()
        for e in entries:
            for a in _entry_axes(e):
                if a in seen or a in target:
                    return [UNKNOWN_SPEC]  # invalid layout: degrade
                seen.add(a)
        return [_trim(entries)]

    def _apply_reduction(self, op, sig, ins_s, ins_t, outs_t, ctx,
                         events):
        if sig.reduce_dims is None or not ins_s:
            return None
        dims = sig.reduce_dims(op, ins_t)
        if dims is None or ins_s[0] is UNKNOWN_SPEC \
                or ins_t[0].shape is None:
            return None
        rank = len(ins_t[0].shape)
        sp = _pad(ins_s[0], rank)
        dimset = set(d % rank for d in dims)
        red_axes: List[str] = []
        for d in sorted(dimset):
            for a in _entry_axes(sp[d]):
                if a not in red_axes:
                    red_axes.append(a)
        out_t = outs_t[0] if outs_t else UNKNOWN
        out_name = op.output_arg_names[0] if op.output_arg_names else None
        if red_axes:
            # the partitioner merges every reduced mesh axis into ONE
            # all-reduce instruction (verified against the lowerings)
            events.append(CommEvent(
                "all-reduce", "reduction", *ctx, out_name,
                tuple(red_axes), _nbytes(out_t)))
        if out_t.shape is None:
            return [UNKNOWN_SPEC]
        if len(out_t.shape) == rank:  # keep-dim reduction
            entries = [None if d in dimset else sp[d]
                       for d in range(rank)]
        else:
            entries = [sp[d] for d in range(rank) if d not in dimset]
            if len(entries) != len(out_t.shape):
                return [UNKNOWN_SPEC]
        return [_trim(entries)]

    def _apply_constraint(self, op, ins_s, ins_t, outs_t, ctx, events):
        from ..sharding.rules import clean_spec, dropped_axes

        src = ins_s[0] if ins_s else UNKNOWN_SPEC
        t = outs_t[0] if outs_t else (ins_t[0] if ins_t else UNKNOWN)
        shape = t.shape
        name = op.output_arg_names[0] if op.output_arg_names else None
        # suggest_constraints iterates what-if sweeps through overrides
        # instead of mutating the program (read-only contract)
        raw = self.constraint_overrides.get(name, op.attrs.get("spec"))
        if raw is None or shape is None or any(d < 0 for d in shape):
            # unresolvable target: the spec re-cleans against the run's
            # shape; identity is the only safe static claim
            return [src]
        for axis, dim_idx in dropped_axes(self.mesh, raw, shape):
            self.result.indivisible.add((name, axis, dim_idx))
        dst = clean_spec(self.mesh, raw, shape)
        if src is UNKNOWN_SPEC:
            return [tuple(dst)]  # the constraint pins the layout
        events.extend(_transition_events(
            self.mesh, spec_axes(_pad(src, len(shape))), spec_axes(dst),
            "constraint-transition", ctx, name, _nbytes(t)))
        return [tuple(dst)]

    def _apply_comm(self, op, sig, ins_s, ins_t, outs_t, ctx, events):
        kind = sig.kind
        n_out = len(op.output_arg_names)
        if kind == "elementwise":
            out_t = outs_t[0] if outs_t else UNKNOWN
            merged = _merge_elementwise(ins_s, ins_t, out_t)
            return None if merged is None else [merged] * n_out
        if kind == "passthrough":
            if not ins_s or ins_s[0] is UNKNOWN_SPEC:
                return None
            return [ins_s[0]] * n_out
        if kind == "mirror":
            if any(s is UNKNOWN_SPEC for s in ins_s):
                return None
            return [ins_s[j] if j < len(ins_s) else ()
                    for j in range(n_out)]
        if kind == "contraction":
            return self._apply_contraction(op, sig, ins_s, ins_t,
                                           outs_t, ctx, events)
        if kind == "reduction":
            return self._apply_reduction(op, sig, ins_s, ins_t, outs_t,
                                         ctx, events)
        if kind == "rowwise":
            if not ins_s or ins_s[0] is UNKNOWN_SPEC \
                    or ins_t[0].shape is None:
                return None
            sp = _pad(ins_s[0], len(ins_t[0].shape))
            if sp and _entry_axes(sp[-1]):
                return None  # sharded normalization dim: partitioner's
            return [ins_s[0]] * n_out
        if kind == "transpose":
            perm = op.attrs.get("perm")
            if perm is None or not ins_s or ins_s[0] is UNKNOWN_SPEC \
                    or ins_t[0].shape is None:
                return None
            sp = _pad(ins_s[0], len(ins_t[0].shape))
            if len(perm) != len(sp):
                return None
            return [_trim(sp[p] for p in perm)]
        if kind == "constraint":
            return self._apply_constraint(op, ins_s, ins_t, outs_t, ctx,
                                          events)
        if kind == "replicated_out":
            return [()] * n_out
        if kind == "attention":
            if len(ins_s) < 3 or any(s is UNKNOWN_SPEC
                                     for s in ins_s[:3]):
                return None
            specs = [_pad(s, 3) for s in ins_s[:3]]
            if any(_entry_axes(e) != _entry_axes(specs[0][j])
                   for sp in specs[1:] for j, e in enumerate(sp)):
                return None  # Q/K/V layouts diverge: degrade
            if any(_entry_axes(e) for e in specs[0][1:]):
                return None  # sharded beyond batch: the partitioner's pick
            return [ins_s[0]] * n_out
        if kind == "gather_table":
            if len(ins_s) < 2 or ins_s[0] is UNKNOWN_SPEC \
                    or ins_s[1] is UNKNOWN_SPEC:
                return None
            if spec_axes(ins_s[1]):
                return None  # sharded table: the partitioner's strategy
            out_t = outs_t[0] if outs_t else UNKNOWN
            if out_t.shape is None:
                return None
            rank = len(out_t.shape)
            return [_trim(_pad(ins_s[0], rank - 1) + (None,))]
        return None

    # -- the walk -------------------------------------------------------
    def run(self):
        block, result = self.block, self.result
        for i, op in enumerate(block.ops):
            ins_t = [self.type_of(n) for n in op.input_arg_names]
            try:
                outs_t = _infer_op(op, ins_t)
            except SignatureError:
                outs_t = None
            if outs_t is None:
                outs_t = [UNKNOWN] * len(op.output_arg_names)
            typed: List[TensorType] = []
            for name, inferred in zip(op.output_arg_names, outs_t):
                decl = declared_type(block._find_var_recursive(name))
                t = (meet(inferred, decl)
                     if shapes_compatible(inferred.shape, decl.shape)
                     and (inferred.dtype is None or decl.dtype is None
                          or inferred.dtype == decl.dtype)
                     else inferred)
                self.tenv[name] = t
                typed.append(t)

            ins_s = [self.spec_of(n) for n in op.input_arg_names]
            ctx = (block.idx, i, op.type)
            events: List[CommEvent] = []
            sig = get_comm_signature(op.type)
            outs_s = None
            if sig is not None:
                outs_s = self._apply_comm(op, sig, ins_s, ins_t, typed,
                                          ctx, events)
            if outs_s is None:
                result.unknowns.add(op.type)
                outs_s = [UNKNOWN_SPEC] * len(op.output_arg_names)

            for name, s, t in zip(op.output_arg_names, outs_s, typed):
                self.senv[name] = s
                var = block._find_var_recursive(name)
                if (var is not None and var.persistable
                        and s is not UNKNOWN_SPEC
                        and op.type != "sharding_constraint"):
                    want = tuple(self.plan.spec_for(var, name, t.shape))
                    if set(spec_axes(s)) != set(spec_axes(want)):
                        events.append(CommEvent(
                            "reshard", "persistable-write", *ctx, name,
                            tuple(spec_axes(s)), _nbytes(t)))
            result.events.extend(events)
            result.op_specs.append(
                OpSpecs(block.idx, i, op.type, ins_s, outs_s, events))

        for name, s in self.senv.items():
            result.specs[(block.idx, name)] = s
        for name, t in self.tenv.items():
            result.types[(block.idx, name)] = t


def propagate_specs(program, plan=None,
                    feed_shapes: Optional[Dict[str, Sequence[int]]] = None,
                    batch_size: Optional[int] = None,
                    constraint_overrides: Optional[Dict[str, Tuple]] = None
                    ) -> SpmdResult:
    """Walk every block of ``program`` under ``plan`` (default: the
    attached ``_sharding_plan``), returning the :class:`SpmdResult`
    with per-var layouts and the predicted :class:`CommEvent` stream.

    Read-only: the program, the plan and its spec cache are never
    mutated. A planless (or 1-device) program returns an empty result
    with ``planless=True`` — nothing to predict, nothing faked.
    """
    plan = plan if plan is not None \
        else getattr(program, "_sharding_plan", None)
    if plan is None or plan.mesh.size() <= 1:
        return SpmdResult(planless=True)
    result = SpmdResult()
    if batch_size is None:
        batch_size = plan.mesh.batch_size_multiple()
        result.notes.append(
            "dynamic batch dims assumed = mesh batch_size_multiple "
            f"({batch_size}) — the smallest shardable batch; pass "
            "batch_size for exact bytes")
    feed_shapes = dict(feed_shapes or {})
    for b in program.blocks:
        shapes = dict(feed_shapes)
        for name, var in b.vars.items():
            if getattr(var, "is_data", False) and name not in shapes \
                    and var.shape is not None:
                shapes[name] = tuple(batch_size if d == -1 else d
                                     for d in var.shape)
        _BlockWalker(b, plan, result, shapes, constraint_overrides).run()
    return result
