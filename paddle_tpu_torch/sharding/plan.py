"""The SPMD sharding pass: rewrite a Program for a named DP x FSDP x TP
mesh (counterpart of paddle_tpu/sharding/plan.py).

``shard_program(program, mesh, rules)`` is the JAX package's rewrite
pass, with the same annotations, constraint ops and stamp:

  * every Parameter matched by the ordered partition rules gets its
    ``sharding_spec``;
  * rule-matched *activations* get a ``sharding_constraint`` op injected
    right after their producer. In the JAX package it pins a layout
    for XLA's propagation; the port runs each rank's block of the
    batch by construction, so the op passes its input through (it
    keeps the op list, and the constraint count, the JAX package's);
  * optimizer moments and the f32 AMP master params are resolved to
    live *sharded along ``fsdp``* (ZeRO): through name-family rule
    matching, and any accumulator left replicated on dim 0 over
    ``fsdp`` (:meth:`ShardingPlan.spec_for`);
  * ``program._sharding_stamp`` = (mesh shape, rule digest) is composed
    into compile-cache fingerprints exactly like ``_amp_stamp`` —
    absent (not None) when the pass never ran.

What the port does with a plan is ``sharding/spmd.py``'s: each rank
keeps its block of every tensor the plan shards, gathers parameters for
the forward and backward ops, and runs each update on the blocks of its
accumulators.

A 1-device mesh (or ``mesh=None``) returns the program UNTOUCHED — no
ops, no stamp, no version bump. Like AMP, the pass must run BEFORE
``append_backward``/``minimize``: shard first, then minimize.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from ..core.enforce import enforce
from ..core.program import Block, Operator, Parameter, Program, Variable
from .mesh import DeviceMesh, FSDP_AXIS, Layout
from .rules import (Rule, clean_spec, default_rules, dropped_axes,
                    match_partition_rules, rules_digest, shard_count)

# (var, axis) pairs already warned about this process — clean_spec's
# indivisibility dropping used to be fully silent, so a plan that asked
# for a shard and silently got replication was invisible until the HBM
# numbers disagreed. One warning per pair (the _fallback_warn idiom —
# a training loop resolving specs every step must not spam), plus a
# labeled obs counter so fleet telemetry can alert on it.
_DROP_WARNED: set = set()


def _warn_spec_drop(name: str, spec, shape, mesh: DeviceMesh) -> None:
    import warnings

    from ..core import flags
    from ..obs import metrics

    for axis, dim_idx in dropped_axes(mesh, spec, shape):
        metrics.counter(
            "sharding_spec_dropped_total",
            "spec entries clean_spec dropped for indivisibility",
            labels=("var", "axis")).labels(var=name, axis=axis).inc()
        if (name, axis) in _DROP_WARNED \
                and not flags.get_flag("debug_fallback"):
            continue
        _DROP_WARNED.add((name, axis))
        warnings.warn(
            f"sharding: spec for {name!r} asked to shard dim {dim_idx} "
            f"over mesh axis {axis!r} but {tuple(shape)} does not "
            "divide — the entry is dropped and the tensor REPLICATES "
            "over that axis (pad the dim or adjust the rule)",
            stacklevel=4)


class ShardingPlan:
    """Resolved (mesh, rules) for one program: every variable name maps
    to a mesh layout on demand. Attached as ``program._sharding_plan``
    (carried by ``Program.clone``); the executor builds its jit
    in/out_shardings and feed/state placement through this object, and
    ``analysis.liveness`` divides the HBM report through
    :meth:`shard_counts`."""

    def __init__(self, mesh: DeviceMesh, rules: Sequence[Rule],
                 zero_shard_moments: bool = True):
        self.mesh = mesh
        self.rules = list(rules)
        self.zero_shard_moments = zero_shard_moments
        self.stamp = "mesh:%s/rules:%s" % (
            ",".join(f"{a}={s}" for a, s in sorted(mesh.shape.items())),
            rules_digest(self.rules))
        # keyed by (name, shape): clean_spec's divisibility dropping
        # depends on the shape, and the same name can resolve under its
        # declared (possibly dynamic) shape AND a concrete value shape
        self._spec_cache: Dict[Tuple, Tuple] = {}

    def __repr__(self):
        return f"ShardingPlan({self.stamp})"

    # -- spec resolution ------------------------------------------------
    def spec_for(self, var: Optional[Variable], name: str,
                 shape: Optional[Sequence[int]] = None) -> Tuple:
        """Cleaned PartitionSpec entries for one variable. Priority:
        explicit ``var.sharding_spec`` (param_attr / legacy transpiler
        plans) > ordered rule match > ZeRO dim-0 fsdp shard for
        replicated optimizer accumulators > replicated."""
        if shape is None and var is not None:
            shape = var.shape
        key = (name, tuple(shape) if shape is not None else None)
        hit = self._spec_cache.get(key)
        if hit is not None:
            return hit
        explicit = getattr(var, "sharding_spec", None) if var is not None \
            else None
        if explicit is None and var is not None:
            from .spmd import follows

            explicit = follows(var, var.block)
        if explicit is not None:
            _warn_spec_drop(name, explicit, shape, self.mesh)
            spec = clean_spec(self.mesh, explicit, shape)
        else:
            matched = match_partition_rules(self.rules, name, shape)
            if matched:
                _warn_spec_drop(name, matched, shape, self.mesh)
            spec = clean_spec(self.mesh, matched or (), shape)
        if (not any(spec) and self.zero_shard_moments and var is not None
                and getattr(var, "is_accumulator", False)
                and shape and int(shape[0]) > 0
                and int(shape[0]) % self.mesh.size(FSDP_AXIS) == 0
                and self.mesh.size(FSDP_AXIS) > 1):
            # ZeRO: an accumulator no rule sharded still lives split over
            # fsdp (dim 0) — the reference Reduce strategy's
            # shard-the-optimizer-state trade, pinned to the fsdp axis
            spec = (FSDP_AXIS,) + (None,) * (len(shape) - 1)
        self._spec_cache[key] = spec
        return spec

    def state_sharding(self, gb: Block, name: str,
                       shape: Optional[Sequence[int]] = None) -> Layout:
        var = gb._find_var_recursive(name)
        return Layout(self.mesh, self.spec_for(var, name, shape))

    def feed_sharding(self, gb: Block, name: str,
                      value_shape: Sequence[int]) -> Layout:
        """Feeds: batch dim split over data x fsdp when divisible (data
        vars and dynamic-batch vars), else rule/replicated."""
        var = gb._find_var_recursive(name)
        batchlike = var is None or var.is_data or (
            var.shape is not None and len(var.shape) > 0
            and var.shape[0] == -1)
        if (batchlike and len(value_shape) > 0
                and int(value_shape[0]) % self.mesh.batch_size_multiple()
                == 0):
            return self.mesh.data_sharding(len(value_shape))
        if var is not None and not batchlike:
            # spec_for honors explicit var.sharding_spec before rules —
            # a fed sharded param keeps its declared layout
            return Layout(self.mesh, self.spec_for(var, name, value_shape))
        return self.mesh.replicated()

    def replicated(self) -> Layout:
        return self.mesh.replicated()

    # -- array placement ------------------------------------------------
    def place(self, value, sharding: Layout):
        """This rank's block of a whole tensor under ``sharding`` (the
        value itself off a live mesh, or when nothing is sharded)."""
        from .comm import take_local

        if not self.mesh.live or not any(sharding.spec):
            return value
        return take_local(value, sharding.spec, self.mesh)

    # -- liveness integration -------------------------------------------
    def shard_counts(self, program: Program) -> Dict[str, int]:
        """name -> number of equal shards, for every declared variable —
        the divisors ``analysis.analyze_liveness`` applies to produce the
        per-device HBM report."""
        out: Dict[str, int] = {}
        for b in program.blocks:
            for name, var in b.vars.items():
                if var.shape is None:
                    continue
                out[name] = shard_count(
                    self.mesh, self.spec_for(var, name), var.shape)
        return out


def _constraint_fn(mesh: DeviceMesh, spec: Tuple):
    """Op fn for one injected constraint: the identity (a run already
    holds its rank's block of the batch; see the module docstring)."""
    del mesh, spec

    def fn(x):
        return x

    return fn


def _inject_constraints(block: Block, plan: ShardingPlan) -> int:
    """Insert one ``sharding_constraint`` op after the producer of every
    rule-matched activation (non-persistable, rank >= 1). The op reads
    and rewrites the SAME name (the unscale-op idiom), so consumers need
    no renaming and the backward slice picks it up naturally."""
    n = 0
    i = 0
    while i < len(block.ops):
        op = block.ops[i]
        i += 1
        if op.fn is None or op.type == "sharding_constraint" \
                or op.attrs.get("_non_tensor_out"):
            continue
        for name in op.output_arg_names:
            v = block._find_var_recursive(name)
            if (v is None or v.persistable or isinstance(v, Parameter)
                    or v.shape is None or len(v.shape) < 1):
                continue
            matched = match_partition_rules(plan.rules, name, v.shape)
            if matched is None or not any(matched):
                continue
            cop = Operator(
                block, "sharding_constraint",
                inputs={"X": [name]}, outputs={"Out": [name]},
                attrs={"spec": tuple(matched), "_sharding_inserted": True},
                fn=_constraint_fn(plan.mesh, tuple(matched)))
            block.ops.insert(i, cop)
            i += 1
            n += 1
    if n:
        block.program._bump()
    return n


def strip_sharding(program: Program) -> Program:
    """Remove the pass's runtime artifacts from ``program`` IN PLACE
    (returns it): every injected ``sharding_constraint`` op (whose fn
    closes over the concrete mesh — fatal inside a single-device export
    or a differently-shaped deployment), the attached plan, and the
    cache stamp. Param ``sharding_spec`` annotations stay — they are
    inert metadata outside an executor that consumes them. io.save_*
    export paths strip their pruned/cloned program through here so
    exported artifacts never reference the training mesh."""
    if getattr(program, "_sharding_plan", None) is None:
        return program
    changed = False
    for b in program.blocks:
        kept = [op for op in b.ops
                if not op.attrs.get("_sharding_inserted")]
        if len(kept) != len(b.ops):
            b.ops = kept
            changed = True
    for attr in ("_sharding_plan", "_sharding_stamp",
                 "_sharding_constraint_count"):
        if hasattr(program, attr):
            delattr(program, attr)
    if changed:
        program._bump()
    return program


def shard_program(program: Program, mesh: Optional[DeviceMesh],
                  rules: Optional[Sequence[Rule]] = None,
                  zero_shard_moments: bool = True) -> Program:
    """Rewrite ``program`` IN PLACE for SPMD execution on ``mesh``;
    returns it.

    ``rules`` — ordered ``(regex, spec)`` partition rules
    (:func:`sharding.default_rules` when omitted). On a 1-device mesh or
    ``mesh=None`` the program is returned UNTOUCHED (no ops, no stamp,
    no version bump) — byte-identical single-device behavior. Must run
    before ``append_backward`` / ``optimizer.minimize`` (see module
    docstring); compose with AMP as ``shard_program`` ->
    ``amp.decorate(opt).minimize(loss)``.
    """
    if mesh is None or mesh.size() <= 1:
        return program
    for b in program.blocks:
        for op in b.ops:
            enforce(op.type != "backward",
                    "sharding.shard_program cannot rewrite a program that "
                    "already has a backward op (its fn closes over the "
                    "pre-rewrite forward ops, so injected constraints "
                    "would not reach the gradient computation) — shard "
                    "before append_backward/minimize")
    rules = list(rules) if rules is not None else default_rules()
    plan = ShardingPlan(mesh, rules, zero_shard_moments=zero_shard_moments)

    # 1. GSPMD param annotations (explicit param_attr specs win)
    for p in program.global_block().all_parameters():
        if getattr(p, "sharding_spec", None) is not None:
            continue
        matched = match_partition_rules(rules, p.name, p.shape)
        if matched is not None and any(
                clean_spec(mesh, matched, p.shape)):
            p.sharding_spec = tuple(matched)

    # 2. activation constraints
    n = 0
    for b in program.blocks:
        n += _inject_constraints(b, plan)

    program._sharding_plan = plan
    program._sharding_stamp = plan.stamp
    program._sharding_constraint_count = n
    program._bump()
    return program
