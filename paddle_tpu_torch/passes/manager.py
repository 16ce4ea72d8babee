"""PassManager: ordered pipelines with centrally-enforced invariants
(counterpart of paddle_tpu/passes/manager.py, the same invariants and
errors; its legacy mode is paddle_tpu/core/passes.py's).

Reference: inference/analysis/analyzer.h runs an ordered pass list over
one graph; MLIR's PassManager adds what the analyzer never had — the
*manager*, not each pass, owns verification. Here that means, after
every pass that changed the program:

  1. **re-infer** — the abstract interpreter
     (``analysis.infer_program_types``) sweeps every block; declared
     symbol-table entries a pass created without shapes/dtypes are
     filled in from the inferred lattice;
  2. **zero-diagnostic invariant** — graph validation + type inference
     must surface NO error diagnostic that was not already present
     before the pipeline ran; a violation raises a structured
     :class:`~paddle_tpu_torch.passes.PassError` naming the pass and
     the offending op;
  3. **declared-write check** — op types that appear in the program but
     were not declared in the pass's ``writes`` set fail loudly;
  4. **stamp composition** — self-stamping passes (``stamp_attr``) are
     verified to have really stamped; every other pass contributes
     ``name=fingerprint()`` to the ordered ``program._passes_stamp``
     (attr ABSENT when no pass ran).

``check=False, stamp=False`` is the legacy mode: the passes in order
and nothing else (``io.save_inference_model``'s pipeline runs so).
"""

from __future__ import annotations

import hashlib
import json
import re
from collections import Counter
from typing import List, Optional, Sequence, Union

from ..core.program import Program
from .base import Pass, PassError, get_pass
from .fusion import (AttentionFusePass, DeadCodeEliminatePass,
                     FcActFusePass, TransposeEliminatePass)


def _op_type_set(program: Program) -> frozenset:
    return frozenset(op.type for b in program.blocks for op in b.ops)


def _program_digest(program: Program) -> str:
    """Content digest of the program at NAME identity: op types, slots,
    attrs (through ``base._stable_value``) and fns, and the symbol
    table. This is what decides whether a clone-returning pass
    *changed* the program: a fusion pass that matched nothing hands back
    an identical clone and must NOT count as a change, or it would
    compose a spurious stamp."""
    from .base import _stable_value

    desc = {
        "blocks": [[[op.type,
                     sorted(op.inputs.items()), sorted(op.outputs.items()),
                     [[k, _stable_value(v)]
                      for k, v in sorted(op.attrs.items())],
                     getattr(op.fn, "__qualname__", None)]
                    for op in b.ops]
                   for b in program.blocks],
        "vars": [[n, [list(v.shape) if v.shape is not None else None,
                      str(v.dtype) if v.dtype is not None else None,
                      bool(v.persistable), int(v.lod_level),
                      str(v.type)]]
                 for b in program.blocks
                 for n, v in sorted(b.vars.items())],
    }
    return hashlib.sha256(
        json.dumps(desc, sort_keys=True, default=str).encode()
    ).hexdigest()


_OP_INDEX = re.compile(r"op#\d+")


def _error_key(d) -> tuple:
    """One diagnostic keyed independently of op INDEX — a pass
    inserting ops shifts indices without changing which defects
    exist, so the invariant compares (code, op_type, var, message)
    with ``op#N`` references in the message normalized away (validator
    messages embed indices, e.g. use-before-def's 'read at op#2';
    without the normalization an op-inserting pass would re-key a
    tolerated pre-existing error and fail loudly for nothing)."""
    return (d.code, d.op_type, d.var,
            _OP_INDEX.sub("op#?", d.message or ""))


def _error_keys(diagnostics) -> Counter:
    return Counter(_error_key(d) for d in diagnostics if d.is_error)


def _collect_diagnostics(program: Program, inferred=None,
                         lint_comm: bool = False) -> list:
    from ..analysis import analyze_comm, infer_program_types, \
        validate_graph

    diags = list(validate_graph(program))
    if inferred is None:
        inferred = infer_program_types(program)
    diags.extend(inferred.diagnostics)
    if lint_comm:
        # opt-in: comm lints join the zero-new-diagnostic invariant, so
        # a pipeline under lint_comm=True may not INTRODUCE a comm
        # error (e.g. a pass rewriting constraint specs into forced
        # gathers); planless programs contribute nothing
        diags.extend(analyze_comm(program).diagnostics)
    return diags


def refresh_program_types(program: Program, inferred=None) -> int:
    """One re-inference sweep: fill in symbol-table entries that carry
    no declared shape (vars created mid-rewrite) from the abstract
    interpreter's lattice. Returns how many vars were refreshed.
    Declared shapes/dtypes are never overwritten — a disagreement with
    inference is a diagnostic, not something to paper over.
    ``inferred`` lets a caller that already ran the interpreter share
    one sweep (filling only writes values the lattice derived, so the
    fixed point — and its diagnostics — are unchanged by the fill)."""
    from ..analysis import infer_program_types
    from ..analysis.op_registry import UNKNOWN

    if inferred is None:
        inferred = infer_program_types(program)
    n = 0
    for (bidx, name), t in inferred.types.items():
        if t is UNKNOWN or t.shape is None:
            continue
        var = program.blocks[bidx]._find_var_recursive(name)
        if var is None or var.shape is not None:
            continue
        var.shape = list(t.shape)
        if t.dtype is not None:
            var.dtype = t.dtype
        n += 1
    return n


class PassManager:
    """Ordered pass pipeline over one Program (see module docstring).

    ``passes`` — registered names and/or :class:`Pass` instances.
    ``check`` — enforce the central invariants (declared writes, zero
    new diagnostics, stamp discipline). ``lint_comm`` — fold the SPMD
    communication lints (analysis.analyze_comm) into the
    zero-diagnostic invariant: a pass may not introduce a predicted
    forced all-gather (opt-in; default off so unsharded pipelines pay
    nothing). ``stamp`` — compose ``program._passes_stamp`` from the
    non-self-stamping passes that changed the program.
    """

    def __init__(self, passes: Sequence[Union[str, Pass]],
                 check: bool = True, stamp: bool = True,
                 lint_comm: bool = False):
        self.passes: List[Pass] = [
            p if isinstance(p, Pass) else get_pass(p) for p in passes]
        self.check = bool(check)
        self.stamp = bool(stamp)
        self.lint_comm = bool(lint_comm)

    # ------------------------------------------------------------------
    def apply(self, program: Program, scope=None) -> Program:
        baseline = (_error_keys(_collect_diagnostics(
            program, lint_comm=self.lint_comm)) if self.check else None)
        entries: List[str] = []
        digest: Optional[str] = None  # of `program`, when still valid
        for p in self.passes:
            before_types = _op_type_set(program) if self.check else None
            obj0, v0 = program, program._version
            out = p.apply(program, scope=scope)
            if out is None:
                raise PassError(p.name, PassError.BAD_RESULT,
                                "apply() returned None instead of a "
                                "Program")
            if out is obj0:
                # in-place pass: the version bump is its change signal
                # (covers effects outside the op list, e.g. donation
                # flags)
                changed = out._version != v0
                if changed:
                    digest = None
            elif self.check or self.stamp:
                # clone-returning pass: compare CONTENT — a rewrite
                # that matched nothing hands back an identical clone
                # and must not compose a stamp
                if digest is None:
                    digest = _program_digest(obj0)
                out_digest = _program_digest(out)
                changed = out_digest != digest
                digest = out_digest
            else:
                changed = True
            program = out
            if not changed:
                continue
            if self.check:
                self._check_writes(p, before_types, program)
                from ..analysis import infer_program_types

                inferred = infer_program_types(program)
                if refresh_program_types(program, inferred):
                    digest = None  # the fill changed var declarations
                diags = _collect_diagnostics(program, inferred,
                                             lint_comm=self.lint_comm)
                introduced = _error_keys(diags) - baseline
                if introduced:
                    offenders = [d for d in diags if d.is_error and
                                 _error_key(d) in introduced]
                    raise PassError(
                        p.name, PassError.DIAGNOSTICS,
                        "introduced %d diagnostic(s): %s"
                        % (len(offenders),
                           "; ".join(str(d) for d in offenders[:3])),
                        diagnostics=offenders)
                # later passes are judged against the refreshed program
                baseline = _error_keys(diags)
            if p.stamp_attr is not None:
                if self.check and not getattr(program, p.stamp_attr,
                                              None):
                    raise PassError(
                        p.name, PassError.STAMP_OMISSION,
                        "pass declares stamp_attr=%r but did not set "
                        "it on the rewritten program — the rewritten "
                        "program would carry the unrewritten one's "
                        "stamps" % p.stamp_attr)
                continue
            if self.stamp:
                fp = p.fingerprint()
                if not fp or not isinstance(fp, str):
                    raise PassError(
                        p.name, PassError.BAD_FINGERPRINT,
                        "fingerprint() must return a non-empty str, "
                        "got %r" % (fp,))
                entries.append(f"{p.name}={fp}")
        if entries:
            prev = getattr(program, "_passes_stamp", None)
            program._passes_stamp = ";".join(
                ([prev] if prev else []) + entries)
            program._bump()
        return program

    # ------------------------------------------------------------------
    def _check_writes(self, p: Pass, before: frozenset,
                      program: Program) -> None:
        if p.writes is None:
            return
        introduced = _op_type_set(program) - before
        rogue = sorted(introduced - p.writes)
        if rogue:
            raise PassError(
                p.name, PassError.UNDECLARED_WRITE,
                "introduced undeclared op type(s) %s (declared writes: "
                "%s)" % (rogue, sorted(p.writes)), op_types=rogue)

    def __repr__(self):
        return "PassManager(%s)" % ", ".join(p.name for p in self.passes)


def apply_passes(passes: Sequence[Union[str, Pass]], program: Program,
                 scope=None, check: bool = True,
                 stamp: bool = True, lint_comm: bool = False) -> Program:
    """One-call pipeline: ``apply_passes(["dce"], program)``."""
    return PassManager(passes, check=check, stamp=stamp,
                       lint_comm=lint_comm).apply(program, scope=scope)


def inference_pass_pipeline(fetch_names: Sequence[str]) -> PassManager:
    """The default analysis pipeline of exported inference programs
    (reference: analyzer.h's ordered pass list), legacy mode: transpose
    elimination, attention fusion, fc+act fusion, dead-code elimination,
    with ``fetch_names`` as barriers."""
    return PassManager([
        TransposeEliminatePass(keep=fetch_names),
        AttentionFusePass(keep=fetch_names),
        FcActFusePass(keep=fetch_names),
        DeadCodeEliminatePass(keep=fetch_names),
    ], check=False, stamp=False)
