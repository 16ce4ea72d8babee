"""Communication report over the SPMD spec propagation (counterpart of
paddle_tpu/analysis/comm.py, the same report, lints and hints).

Consumes the :class:`~paddle_tpu_torch.analysis.spmd.SpmdResult` event
stream and packages it three ways:

  * **lints** — the four ``comm-*`` diagnostic families, surfaced
    through ``check_program(with_comm=True)``, ``Program.validate``
    and the pass manager's opt-in ``lint_comm``;
  * **roofline attribution** — ``total_bytes``/``counts()`` feed
    ``obs.cost.roofline(comm_report=...)`` so predicted collective
    bytes sit beside the FLOP and memory columns;
  * **constraint hints** — ``suggest_constraints`` turns every
    eliminable transition into a concrete ``sharding_constraint``
    placement, ``apply_suggestions`` rewrites the program in place.

Severity policy: a contraction-induced all-gather on an *activation* is
a layout-design smell — worth a warning, but often the partitioner's
least-cost option. A gather caused by a ``sharding_constraint``
dropping axes the inferred layout already carries is ALWAYS eliminable
(widen the constraint to keep the axes) — that one is an error, and
``suggest_constraints`` emits the exact fix. Parameter gathers under
ZeRO-style specs are the design working as intended and produce no
diagnostic at all.

``count_collectives`` counts the defining collective instructions of
compiled (Stable)HLO text — a pure text function, kept so a program's
prediction can be held to the text the JAX package compiles for it
(tests/test_torch_comm.py).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

from . import diagnostics as diag
from .diagnostics import Diagnostic
from .spmd import (CommEvent, SpmdResult, UNKNOWN_SPEC, _nbytes,
                   propagate_specs, spec_axes)

# Defining collective instructions in (Stable)HLO text: `%name = type
# all-gather(...)`. Operand mentions and metadata lines never match.
_COLLECTIVE_DEF = re.compile(
    r"=\s*\S+\s+(all-gather|all-reduce|reduce-scatter|all-to-all|"
    r"collective-permute)(?:-start|-done)?(?:\.\d+)?\(")

# event kinds that move bytes between devices (reshard =
# collective-permute is a relabeling move, tracked separately from the
# gather/reduce volume)
_VOLUME_KINDS = ("all-gather", "all-reduce", "reduce-scatter")


def count_collectives(hlo_text: str) -> Dict[str, int]:
    """Count defining collective instructions per kind in HLO text.

    A collective inside a scan (while) body appears once in the text and
    once here — matching the analyzer's per-step event convention.
    """
    out: Dict[str, int] = {}
    for line in hlo_text.splitlines():
        m = _COLLECTIVE_DEF.search(line)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0) + 1
    return out


class Suggestion:
    """One concrete ``sharding_constraint`` placement fix."""

    __slots__ = ("var", "spec", "block_idx", "op_idx", "reason")

    def __init__(self, var, spec, block_idx, op_idx, reason):
        self.var = var
        self.spec = tuple(spec)
        self.block_idx = block_idx
        self.op_idx = op_idx
        self.reason = reason

    def __repr__(self):
        return (f"Suggestion(var={self.var!r} spec={self.spec} "
                f"@ block {self.block_idx} op#{self.op_idx}: "
                f"{self.reason})")


class CommReport:
    """Predicted-collective report for one program under one plan."""

    def __init__(self, result: SpmdResult,
                 events: Sequence[CommEvent],
                 diags: Sequence[Diagnostic]):
        self.result = result
        self.events = list(events)
        self.diagnostics = list(diags)

    @property
    def planless(self) -> bool:
        return self.result.planless

    @property
    def unknowns(self) -> tuple:
        """Op types whose comm effect could not be proven. Non-empty
        means predicted counts are a lower bound, not an equality."""
        return tuple(sorted(self.result.unknowns))

    @property
    def complete(self) -> bool:
        return not self.planless and self.result.complete

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    @property
    def total_bytes(self) -> Optional[float]:
        """Predicted static collective volume per step (the JAX
        package's "ICI volume"): the sum of global logical bytes
        entering gather/reduce/scatter collectives.
        ``None`` for a planless program (nothing predicted)."""
        if self.planless:
            return None
        return sum(e.bytes for e in self.events
                   if e.kind in _VOLUME_KINDS and e.bytes is not None)

    def per_op(self) -> List[tuple]:
        """((block_idx, op_idx, op_type), [events]) in program order."""
        grouped: Dict[tuple, List[CommEvent]] = {}
        order: List[tuple] = []
        for e in self.events:
            key = (e.block_idx, e.op_idx, e.op_type)
            if key not in grouped:
                grouped[key] = []
                order.append(key)
            grouped[key].append(e)
        return [(k, grouped[k]) for k in order]

    def render(self) -> str:
        if self.planless:
            return "comm: no sharding plan (nothing to predict)"
        lines = []
        counts = self.counts() or {"(none)": 0}
        head = ", ".join(f"{k} x{v}" for k, v in sorted(counts.items()))
        tb = self.total_bytes
        vol = "?" if tb is None else f"{tb / 1e6:.3f} MB"
        lines.append(f"comm: {head}; static ICI volume {vol}/step")
        for (bi, oi, ot), evs in self.per_op():
            where = (f"block {bi} op#{oi} ({ot})" if oi is not None
                     else f"block {bi} (fetch)")
            for e in evs:
                b = "?" if e.bytes is None else f"{e.bytes:.0f} B"
                lines.append(f"  {where}: {e.kind} over {e.axes} "
                             f"var {e.var!r} [{e.reason}] {b}")
        if self.unknowns:
            lines.append("  unknown comm effect (counts are a lower "
                         "bound): " + ", ".join(self.unknowns))
        for note in self.result.notes:
            lines.append(f"  note: {note}")
        return "\n".join(lines)

    def __str__(self):
        return self.render()


def _build_diagnostics(program, result: SpmdResult) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    blocks = {b.idx: b for b in program.blocks}

    def _persistable(block_idx, name):
        b = blocks.get(block_idx)
        v = b._find_var_recursive(name) if b is not None else None
        return v is not None and v.persistable

    # comm-layout-transition: ERROR when a constraint forces the gather
    # (always eliminable -> suggest_constraints has the fix); WARNING
    # for contraction gathers of activations. Parameter gathers (ZeRO
    # working as designed) stay silent.
    for e in result.events:
        if e.kind != "all-gather":
            continue
        if e.reason == "constraint-transition":
            diags.append(Diagnostic(
                diag.ERROR, diag.COMM_LAYOUT_TRANSITION,
                f"sharding_constraint drops mesh axes {e.axes} the "
                "inferred layout already carries — the partitioner "
                "must all-gather to honor it; widen the constraint "
                "spec to keep the axes (see suggest_constraints)",
                block_idx=e.block_idx, op_idx=e.op_idx,
                op_type=e.op_type, var=e.var))
        elif e.reason == "contraction" \
                and not _persistable(e.block_idx, e.var):
            diags.append(Diagnostic(
                diag.WARNING, diag.COMM_LAYOUT_TRANSITION,
                f"activation layout blocks the contraction: axes "
                f"{e.axes} must all-gather before the dot; consider "
                "re-sharding the producer or operand layouts",
                block_idx=e.block_idx, op_idx=e.op_idx,
                op_type=e.op_type, var=e.var))

    # comm-resharding-churn: >= 2 constraint-forced transitions dropping
    # the SAME mesh axis in one block — one warning naming them all.
    churn: Dict[tuple, List[CommEvent]] = {}
    for e in result.events:
        if e.reason == "constraint-transition" \
                and e.kind in ("all-gather", "reshard"):
            for a in e.axes:
                churn.setdefault((e.block_idx, a), []).append(e)
    for (bi, axis), evs in sorted(churn.items()):
        if len(evs) < 2:
            continue
        names = ", ".join(repr(e.var) for e in evs)
        diags.append(Diagnostic(
            diag.WARNING, diag.COMM_RESHARDING_CHURN,
            f"{len(evs)} constraints in block {bi} repeatedly strip "
            f"mesh axis {axis!r} ({names}): the layout ping-pongs "
            "through the block — align the constraint specs",
            block_idx=bi, var=evs[0].var))

    # comm-indivisible-replication: a spec entry clean_spec dropped
    # because the dim does not divide — the tensor silently replicates
    # over an axis the plan asked to shard.
    for name, axis, dim_idx in sorted(result.indivisible):
        diags.append(Diagnostic(
            diag.WARNING, diag.COMM_INDIVISIBLE_REPLICATION,
            f"dim {dim_idx} is not divisible by mesh axis {axis!r} — "
            "the spec entry is dropped and the tensor replicates over "
            f"{axis!r} (pad the dim or drop the axis from the rule)",
            var=name))

    # comm-sharded-persistable-write: a forward op writes a persistable
    # with a layout that disagrees with the plan's resolved spec — the
    # runtime must reshard on every step's state round-trip.
    for e in result.events:
        if e.reason == "persistable-write":
            diags.append(Diagnostic(
                diag.WARNING, diag.COMM_SHARDED_PERSISTABLE_WRITE,
                f"write lands with axes {e.axes} but the plan resolves "
                "a different layout for this persistable — every step "
                "pays a reshard on the state round-trip",
                block_idx=e.block_idx, op_idx=e.op_idx,
                op_type=e.op_type, var=e.var))
    return diags


def analyze_comm(program, plan=None, feed_shapes=None,
                 batch_size: Optional[int] = None,
                 fetch_list: Sequence = ()) -> CommReport:
    """Predict the collectives an SPMD partitioner must insert for
    ``program`` under ``plan`` (default: the attached sharding plan).

    Read-only; never touches the executor path. Planless programs get
    an empty report with ``planless=True``.
    """
    result = propagate_specs(program, plan=plan,
                             feed_shapes=feed_shapes,
                             batch_size=batch_size)
    if result.planless:
        return CommReport(result, [], [])
    events = list(result.events)
    # fetch boundary: a sharded fetch must gather to a host value
    for f in fetch_list:
        name = f if isinstance(f, str) else f.name
        spec = result.specs.get((0, name), UNKNOWN_SPEC)
        if spec is UNKNOWN_SPEC:
            continue
        axes = spec_axes(spec)
        if axes:
            t = result.types.get((0, name))
            events.append(CommEvent(
                "all-gather", "fetch-gather", 0, None, None, name,
                axes, _nbytes(t) if t is not None else None))
    return CommReport(result, events, _build_diagnostics(program, result))


def suggest_constraints(program, plan=None, feed_shapes=None,
                        batch_size: Optional[int] = None,
                        report: Optional[CommReport] = None
                        ) -> List[Suggestion]:
    """Concrete ``sharding_constraint`` placements that eliminate every
    predicted constraint-forced transition: for each one, the fix is the
    *inferred input layout* at that constraint — pin what propagation
    already proved instead of fighting it.

    Iterated to a fixpoint through what-if re-propagation (read-only:
    ``constraint_overrides``, never program mutation): fixing one
    constraint widens the layout flowing into the next, which may
    expose ITS spec as the new transition — one sweep would stop a
    constraint short of the real fix."""
    if report is not None and report.planless:
        return []
    overrides: dict = {}
    found: dict = {}
    for _ in range(8):  # fixpoint: bounded by constraint chain depth
        res = propagate_specs(program, plan=plan,
                              feed_shapes=feed_shapes,
                              batch_size=batch_size,
                              constraint_overrides=overrides)
        if res.planless:
            return []
        by_op = {(r.block_idx, r.op_idx): r for r in res.op_specs}
        progressed = False
        for e in res.events:
            if e.reason != "constraint-transition" \
                    or e.kind not in ("all-gather", "reshard") \
                    or e.var in overrides:
                continue
            rec = by_op.get((e.block_idx, e.op_idx))
            if rec is None or not rec.in_specs \
                    or rec.in_specs[0] is UNKNOWN_SPEC:
                continue
            spec = tuple(rec.in_specs[0])
            overrides[e.var] = spec
            found[e.var] = Suggestion(
                e.var, spec, e.block_idx, e.op_idx,
                f"constraint drops axes {e.axes} the inferred layout "
                "carries; keep them")
            progressed = True
        if not progressed:
            break
    return list(found.values())


def apply_suggestions(program, suggestions: Sequence[Suggestion],
                      plan=None, allow_training: bool = False) -> int:
    """Rewrite the targeted ``sharding_constraint`` ops IN PLACE to the
    suggested specs (attr AND runtime fn — the fn closes over the spec).
    Returns the number of ops rewritten.

    Refuses programs that carry a ``backward`` op unless
    ``allow_training=True``, as the JAX package does: there, widened
    activation constraints on consecutive tensor-parallel layers trip
    an XLA SPMD partitioner miscompile in the *backward* dots (the
    first layer's gradient diverges while the forward loss stays
    bit-identical). The port's runtime does not act on constraint specs
    (its constraint op is the identity), so a rewrite changes no value
    it computes; it keeps the contract so that one program rewritten in
    either package is the same program.
    """
    from ..core.enforce import enforce
    from ..sharding.plan import _constraint_fn

    plan = plan if plan is not None \
        else getattr(program, "_sharding_plan", None)
    if plan is None or not suggestions:
        return 0
    has_backward = any(op.type == "backward"
                       for b in program.blocks for op in b.ops)
    enforce(
        allow_training or not has_backward,
        "apply_suggestions: program has a backward op — widened "
        "activation constraints are only validated on forward/serving "
        "programs (XLA's partitioner miscompiles the transposed dots "
        "under suggestion-widened specs; gradients come out wrong while "
        "the loss looks fine). Apply suggestions to the serving/forward "
        "program, or pass allow_training=True if you have independently "
        "verified gradients on your mesh/backend.")
    wanted = {s.var: s for s in suggestions}
    n = 0
    for b in program.blocks:
        for op in b.ops:
            if op.type != "sharding_constraint" \
                    or not op.output_arg_names:
                continue
            s = wanted.get(op.output_arg_names[0])
            if s is None:
                continue
            op.attrs["spec"] = tuple(s.spec)
            op.fn = _constraint_fn(plan.mesh, tuple(s.spec))
            n += 1
    if n:
        program._bump()
    return n
