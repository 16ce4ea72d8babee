"""Scheduling passes (counterpart of paddle_tpu/passes/schedule.py): the
pass family that reasons about WHEN, not WHAT.

Ported: :class:`RematPolicyPass` (``remat_policy``) and the rewrite
behind it, :func:`apply_remat_policy`. It replaces the all-or-nothing
``memory_optimize(level>=1)`` remat flag with a per-segment
checkpointing policy solved as a greedy knapsack: segment the forward
slice at compute anchors, price each segment's activation footprint
from ``analysis.analyze_liveness`` at the TARGET batch against its
recompute FLOPs from ``obs.cost``, and checkpoint the
cheapest-to-recompute segments until the target batch fits the memory
budget the current batch already uses. The executor runs each chosen
segment under ``torch.utils.checkpoint`` (executor.py,
``_run_forward_remat``). Provable win: ``MemoryReport.peak_device_bytes``
at 2x batch <= the 1x budget, no run of the larger batch required.

Ported too: :class:`HostOffloadPass` (``host_offload``), which moves
optimizer moments (and, under AMP, the f32 masters) out of device
memory between steps: the executor copies them to pinned host memory
after each step and back to the card on a copy stream while the next
step's forward and backward ops run (``Executor._stage_offload``), so
the update op, the first reader, waits only for what is left of the
copy. Provable win: persistable device bytes drop in liveness and
between steps on the card; losses stay BIT-identical (values
round-trip device->host->device with no cast). Under a captured
``run_steps`` graph on a card the state stays on the card (the graph
reads and writes fixed addresses).

Ported too: :class:`CommOverlapPass` (``comm_overlap``), which pins the
constraint specs ``analysis.suggest_constraints`` proves from
propagation (iterated to a fixpoint), then re-slots the
``sharding_constraint`` ops right after their producers, so the
collective each one implies is issued as early as dataflow allows.
Provable win: ``analysis.analyze_comm``'s predicted collective
count/bytes drop. The port's runtime does not act on constraint specs
(its constraint op is the identity), so the rewrite changes no value a
run computes; its program and stamp are the JAX package's.

A pass here stamps the shared ordered ``program._schedule_stamp``.
"""

from __future__ import annotations

from typing import Optional

from ..core.program import Parameter, Program
from .base import Pass, register_pass

#: forward op types that start a new remat segment: the compute the
#: policy may choose to re-run (cheap relative to the activations the
#: segment would otherwise pin across the forward->backward gap)
SEGMENT_ANCHORS = frozenset({
    "matmul", "mul", "conv2d", "depthwise_conv2d", "fused_attention",
    "lookup_table",
})


def _stamp_schedule(program: Program, entry: str) -> None:
    """Compose one ordered ``name=fingerprint`` entry into the shared
    ``program._schedule_stamp`` (';'-joined, order-preserving) and bump
    the program version so executors re-specialize."""
    prev = getattr(program, "_schedule_stamp", None)
    program._schedule_stamp = ";".join(([prev] if prev else []) + [entry])
    program._bump()


@register_pass("comm_overlap")
class CommOverlapPass(Pass):
    """Pin propagation-proven constraint specs + re-slot constraints
    early (module docstring). No-op — byte-identical, nothing stamped —
    when the program carries no sharding plan, no constraint ops, or a
    ``backward`` op (the spec-widening rewrite is refused after the
    backward, as ``analysis.apply_suggestions`` refuses it; run this
    pass between ``sharding`` and ``minimize()``, exactly where
    ``sharding`` runs).
    """

    stamp_attr = "_schedule_stamp"
    reads = frozenset({"sharding_constraint", "*"})
    writes = frozenset({"sharding_constraint"})

    def __init__(self, batch_size: Optional[int] = None,
                 max_iter: int = 4, reslot: bool = True):
        self.batch_size = batch_size
        self.max_iter = int(max_iter)
        self.reslot = bool(reslot)

    def fingerprint(self) -> str:
        return (f"{self.name}/bs:{self.batch_size}"
                f"/iter:{self.max_iter}/reslot:{int(self.reslot)}")

    # -- dataflow-safe re-slotting -------------------------------------
    @staticmethod
    def _hoist_constraints(program: Program) -> int:
        """Move each ``sharding_constraint`` op to the earliest slot its
        dataflow allows (right after the last op that defines one of its
        inputs) so the collective it implies enters the instruction
        stream as early as possible. Pure reorder: def-use edges are
        preserved, so the computation is unchanged — only a scheduler's
        freedom grows. Returns how many ops moved."""
        gb = program.global_block()
        moved = 0
        i = 0
        while i < len(gb.ops):
            op = gb.ops[i]
            if op.type != "sharding_constraint":
                i += 1
                continue
            ins = set(op.input_arg_names)
            outs = set(op.output_arg_names)
            target = 0
            for j in range(i):
                prev = gb.ops[j]
                pdefs = set(prev.output_arg_names)
                # must stay after producers of our inputs, after any
                # earlier def of our outputs, and after earlier readers
                # of the names we redefine (anti-dependence)
                if pdefs & ins or pdefs & outs \
                        or outs & set(prev.input_arg_names):
                    target = j + 1
            if target < i:
                gb.ops.insert(target, gb.ops.pop(i))
                moved += 1
            i += 1
        return moved

    def apply(self, program: Program, scope=None) -> Program:
        from ..analysis import apply_suggestions, suggest_constraints

        if getattr(program, "_sharding_plan", None) is None:
            return program
        gb = program.global_block()
        if not any(op.type == "sharding_constraint" for op in gb.ops):
            return program
        if any(op.type == "backward" for op in gb.ops):
            return program
        changed = 0
        for _ in range(max(1, self.max_iter)):
            sugg = suggest_constraints(program,
                                       batch_size=self.batch_size)
            if not sugg:
                break
            n = apply_suggestions(program, sugg)
            changed += n
            if not n:
                break
        moved = self._hoist_constraints(program) if self.reslot else 0
        if changed or moved:
            _stamp_schedule(program, f"{self.name}={self.fingerprint()}")
        return program


# ---------------------------------------------------------------------------
# remat_policy
# ---------------------------------------------------------------------------


def _annotate_segments(fwd_ops, max_segments: int = 4) -> int:
    """Split the forward slice into at most ``max_segments`` contiguous
    segments, cutting at :data:`SEGMENT_ANCHORS` ops (every
    ``ceil(n_anchors / max_segments)``-th anchor starts a new segment);
    write ``_remat_segment`` ids onto the ops (consumed by
    ``backward.remat_segment_plan`` and the executor's segmented
    checkpoints). Returns the segment count.

    Granularity matters: a checkpointed segment retains its BOUNDARY
    activations (a checkpoint saves the segment's inputs), so
    anchor-per-op segmentation retains one boundary per matmul and the
    floor can exceed the no-remat budget — a handful of coarse segments
    keeps the boundary overhead a small fraction of what the interior
    activations save."""
    import math

    anchors = [i for i, op in enumerate(fwd_ops)
               if op.type in SEGMENT_ANCHORS]
    stride = max(1, math.ceil(len(anchors) / max(1, max_segments)))
    cuts = set(anchors[::stride]) - {0}
    sid = 0
    for i, op in enumerate(fwd_ops):
        if i in cuts:
            sid += 1
        op.attrs["_remat_segment"] = sid
    return sid + 1


def _strip_segments(fwd_ops) -> None:
    for op in fwd_ops:
        op.attrs.pop("_remat_segment", None)


def apply_remat_policy(program: Program, target_batch: Optional[int] = None,
                       assume_batch: int = 1,
                       hbm_budget: Optional[int] = None,
                       segments: str = "auto", max_segments: int = 4,
                       stamp: bool = True) -> bool:
    """The rewrite behind :class:`RematPolicyPass` (module-level so
    ``memory_optimize(level>=1)`` can call it with ``segments="all",
    stamp=False``: the all-or-nothing flag). Returns True when the
    program changed. ``hbm_budget`` is the device-memory budget in
    bytes (the JAX package's name)."""
    if segments == "all":
        # all-or-nothing: the memory_optimize(level>=1) flag, set
        # unconditionally (the legacy transpiler never looked for a
        # backward op)
        program._memory_optimize_remat = True
        program._bump()
        if stamp:
            _stamp_schedule(program, "remat_policy=remat_policy/seg:all")
        return True

    gb = program.global_block()
    bw = next((op for op in gb.ops if op.type == "backward"), None)
    if bw is None:
        return False

    from ..analysis import analyze_liveness
    from ..backward import _forward_slice, remat_segment_plan
    from ..obs import cost as obs_cost

    targets = bw.attrs.get("targets") or ()
    root = bw.attrs.get("loss") or (targets[0] if targets else None)
    if root is None:
        return False
    fwd_ops, _ext = _forward_slice(program, root)
    if not fwd_ops:
        return False

    budget = hbm_budget if hbm_budget is not None else analyze_liveness(
        program, assume_batch=assume_batch, remat=False).peak_device_bytes
    tb = target_batch if target_batch is not None else 2 * assume_batch

    _annotate_segments(fwd_ops, max_segments=max_segments)
    rep_tb = analyze_liveness(program, assume_batch=tb, remat=False)
    if rep_tb.peak_device_bytes <= budget:
        _strip_segments(fwd_ops)  # already fits: byte-identical no-op
        return False

    crep = obs_cost.report(program, batch_size=tb)
    pos = {id(op): i for i, op in enumerate(gb.ops)}
    stats = []
    for sid, seg_ops, _needed, _keep in remat_segment_plan(fwd_ops, root):
        defs = {n for op in seg_ops for n in op.output_arg_names}
        saved = sum(rep_tb.lives[n].device_bytes
                    for n in defs if n in rep_tb.lives)
        flops = sum(crep.ops[pos[id(op)]].flops or 0.0 for op in seg_ops
                    if id(op) in pos)
        if saved > 0:
            stats.append((saved / (flops + 1.0), sid))
    stats.sort(reverse=True)

    chosen = set()
    peak = rep_tb.peak_device_bytes
    for _ratio, sid in stats:
        if peak <= budget:
            break
        chosen.add(sid)
        peak = analyze_liveness(program, assume_batch=tb,
                                remat=frozenset(chosen)).peak_device_bytes
    if not chosen:
        _strip_segments(fwd_ops)
        return False

    program._remat_policy = tuple(sorted(chosen))
    program._bump()
    if stamp:
        _stamp_schedule(
            program,
            "remat_policy=remat_policy/tb:%d/budget:%d/seg:%s"
            % (tb, budget, ",".join(map(str, sorted(chosen)))))
    return True


@register_pass("remat_policy")
class RematPolicyPass(Pass):
    """Liveness-driven per-segment checkpointing (module docstring).
    No-op when the program carries no ``backward`` op, or when the
    target batch already fits the budget without remat."""

    stamp_attr = "_schedule_stamp"
    requires_backward = True
    reads = frozenset({"backward", "*"})
    writes = frozenset()

    def __init__(self, target_batch: Optional[int] = None,
                 assume_batch: int = 1,
                 hbm_budget: Optional[int] = None,
                 segments: str = "auto", max_segments: int = 4):
        self.target_batch = target_batch
        self.assume_batch = int(assume_batch)
        self.hbm_budget = hbm_budget
        self.segments = segments
        self.max_segments = int(max_segments)

    def fingerprint(self) -> str:
        return (f"{self.name}/tb:{self.target_batch}"
                f"/ab:{self.assume_batch}/budget:{self.hbm_budget}"
                f"/seg:{self.segments}/max:{self.max_segments}")

    def apply(self, program: Program, scope=None) -> Program:
        apply_remat_policy(program, target_batch=self.target_batch,
                           assume_batch=self.assume_batch,
                           hbm_budget=self.hbm_budget,
                           segments=self.segments,
                           max_segments=self.max_segments)
        return program


# ---------------------------------------------------------------------------
# host_offload
# ---------------------------------------------------------------------------


def _offload_candidates(program: Program, include_masters: bool,
                        include_moments: bool):
    """Persistable state eligible for host residency between steps:
    optimizer accumulators (per-param moments AND the fused
    ``fused_<key>_storage`` flat groups — both carry
    ``is_accumulator``), plus — under AMP, where the in-graph compute
    copies are bf16 casts — the f32 masters (trainable f32 Parameters,
    or the fused ``fused_param_storage`` group). Per-name views sliced
    from fused storage are never offloaded: the flat buffer is the
    state, the views alias it."""
    import numpy as np

    gb = program.global_block()
    views = set(getattr(program, "_flat_state_views", None) or {})
    amp = bool(getattr(program, "_amp_stamp", None))
    names = []
    for n, v in gb.vars.items():
        if not getattr(v, "persistable", False) or n in views:
            continue
        if include_moments and getattr(v, "is_accumulator", False):
            names.append(n)
        elif include_masters and amp:
            if isinstance(v, Parameter) and getattr(v, "trainable", True) \
                    and isinstance(v.dtype, np.dtype) \
                    and v.dtype == np.float32:
                names.append(n)
            elif n.startswith("fused_param_storage"):
                names.append(n)
    return sorted(names)


@register_pass("host_offload")
class HostOffloadPass(Pass):
    """Optimizer-state host offload (module docstring): marks the
    selected persistables in ``program._host_offload_state``; the
    executor keeps them in pinned host memory between steps and copies
    them back to the card on a copy stream behind the next step's
    forward and backward ops (``reader.prefetch.overlap_iter``). No-op
    when the program carries no optimizer accumulators (nothing to
    offload)."""

    stamp_attr = "_schedule_stamp"
    requires_backward = True
    reads = frozenset({"*"})
    writes = frozenset()

    def __init__(self, include_masters: bool = True,
                 include_moments: bool = True):
        self.include_masters = bool(include_masters)
        self.include_moments = bool(include_moments)

    def fingerprint(self) -> str:
        return (f"{self.name}/masters:{int(self.include_masters)}"
                f"/moments:{int(self.include_moments)}")

    def apply(self, program: Program, scope=None) -> Program:
        names = _offload_candidates(program, self.include_masters,
                                    self.include_moments)
        if not names:
            return program
        prev = tuple(getattr(program, "_host_offload_state", ()) or ())
        merged = tuple(sorted(set(prev) | set(names)))
        if merged == prev:
            return program
        program._host_offload_state = merged
        program._bump()
        _stamp_schedule(program, f"{self.name}={self.fingerprint()}")
        return program
