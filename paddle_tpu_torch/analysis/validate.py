"""Graph validator: structural well-formedness of a Program (counterpart
of paddle_tpu/analysis/validate.py, the same checks and messages).

Reference: the checks Fluid runs while constructing/executing a
ProgramDesc — OpDesc::CheckAttrs + the var-existence PADDLE_ENFORCEs in
executor.cc:94-129 and framework.py's append_op plumbing — surfaced here
*before* execution as structured Diagnostic records instead of a C++
abort mid-run.

Diagnostic classes:

  undefined-var        input name resolvable in no symbol table
  subblock-unresolved  same, from a sub-block (absent from ALL ancestors)
  use-before-def       input produced only by a LATER op of the block
  maybe-uninitialized  read, never produced, and not feed/state material
  write-after-write    two ops write one persistable (last-write-wins
                       would silently drop the first update); a later
                       write that reads the value first continues a
                       chain, and an ``unpack_flat_params`` op refreshes
                       a view of a flat buffer: neither is one (the JAX
                       package flags both: ROADMAP Queue C)
  dangling-fetch       fetch target no op produces and no table declares
  donation-alias       donated state read before AND after its in-place
                       rewrite — with buffer donation the pre-step value
                       is consumed, so the two reads see different
                       snapshots of what the program treats as one var

Donation is resolved by the port's executor rule
(``executor._resolve_donation``), as the run will resolve it.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Set

from ..core.program import Program
from . import diagnostics as diag
from .dataflow import compute_def_use
from .diagnostics import Diagnostic

_UNPACK = "unpack_flat_params"

def _reader_bound_names(program) -> Set[str]:
    names: Set[str] = set()
    for rd in getattr(program, "_readers", ()):
        names.update(getattr(rd, "out_names", ()) or ())
    return names


def validate_graph(program: Program,
                   feed: Iterable[str] = (),
                   fetch_list: Iterable = (),
                   donate: Optional[bool] = None) -> List[Diagnostic]:
    """Run every structural check; returns diagnostics (possibly empty).

    ``feed`` — names the caller will feed (suppresses uninitialized-read
    findings for them); ``fetch_list`` — names/Variables the caller will
    fetch (checked for danglingness); ``donate`` — buffer-donation
    assumption for the alias check (None = resolve the program's own
    donation setting, exactly as the Executor will).
    """
    feed_names = {getattr(f, "name", f) for f in (feed or ())}
    fetch_names = [getattr(f, "name", f) for f in (fetch_list or ())]
    reader_names = _reader_bound_names(program)
    out: List[Diagnostic] = []

    if donate is None:
        from ..executor import _resolve_donation

        donate = _resolve_donation(program)

    for block in program.blocks:
        du = compute_def_use(block.ops)
        unresolved_code = (diag.UNDEFINED_VAR if block.idx == 0
                           else diag.SUBBLOCK_UNRESOLVED)

        for i, op in enumerate(block.ops):
            for n in op.input_arg_names:
                v = block._find_var_recursive(n)
                if v is None:
                    where = ("no symbol table" if block.idx == 0 else
                             "this block nor any ancestor scope")
                    out.append(Diagnostic(
                        diag.ERROR, unresolved_code,
                        f"reads a variable declared in {where}",
                        block_idx=block.idx, op_idx=i, op_type=op.type,
                        var=n))
                    continue
                if (v.persistable or v.is_data or n in feed_names
                        or n in reader_names):
                    continue  # scope/feed material: defined at entry
                if v.block is not block:
                    continue  # captured from an ancestor block's env
                first_def = du.first_def.get(n)
                if first_def is None:
                    out.append(Diagnostic(
                        diag.WARNING, diag.MAYBE_UNINITIALIZED,
                        "reads a non-persistable variable no op produces "
                        "— it must be fed at run time or the Executor "
                        "will reject the program",
                        block_idx=block.idx, op_idx=i, op_type=op.type,
                        var=n))
                elif first_def > i:
                    out.append(Diagnostic(
                        diag.ERROR, diag.USE_BEFORE_DEF,
                        f"read at op#{i} but first produced by op#"
                        f"{first_def} "
                        f"({block.ops[first_def].type}) — ops execute in "
                        "program order",
                        block_idx=block.idx, op_idx=i, op_type=op.type,
                        var=n))

        # -- write-after-write on persistables --------------------------
        for n, defs in du.defs.items():
            # an unpack_flat_params op refreshes a fused parameter's view
            # of its flat buffer; the executor writes back the buffer,
            # never the view (executor._written_persistables)
            defs = [j for j in defs if block.ops[j].type != _UNPACK]
            if len(defs) < 2:
                continue
            v = block._find_var_recursive(n)
            if v is None or not v.persistable:
                continue
            if all(n in block.ops[j].input_arg_names for j in defs[1:]):
                # a read-modify-write chain (the dropout counter every
                # site reads and advances): each write carries the
                # earlier ones, so the last value drops no update
                continue
            prev = ", ".join(f"op#{j} ({block.ops[j].type})"
                             for j in defs[:-1])
            out.append(Diagnostic(
                diag.ERROR, diag.WRITE_AFTER_WRITE,
                f"persistable variable written by {len(defs)} ops — "
                f"{prev} are overwritten by op#{defs[-1]} "
                f"({block.ops[defs[-1]].type}); only the last value "
                "reaches the scope",
                block_idx=block.idx, op_idx=defs[-1],
                op_type=block.ops[defs[-1]].type, var=n))

        # -- donation-alias: donated state read around its rewrite ------
        if donate and block.idx == 0:
            out.extend(_donation_alias(block, du))

    # -- dangling fetch targets -----------------------------------------
    gb = program.global_block()
    gdu = compute_def_use(gb.ops)
    for n in fetch_names:
        if n in gdu.defs:
            continue
        v = gb._find_var_recursive(n)
        if v is None:
            out.append(Diagnostic(
                diag.ERROR, diag.DANGLING_FETCH,
                "fetch target is produced by no op and declared in no "
                "symbol table",
                block_idx=0, var=n))
        elif not (v.persistable or v.is_data or n in feed_names
                  or n in reader_names):
            out.append(Diagnostic(
                diag.ERROR, diag.DANGLING_FETCH,
                "fetch target is neither produced by any op nor feed/"
                "scope material — Executor.run would reject it",
                block_idx=0, var=n))
    return out


def _donation_alias(block, du) -> List[Diagnostic]:
    """With buffer donation, a persistable read by an EARLY op, then
    rewritten in place, then read AGAIN later, exposes two different
    snapshots under one name — and the donated pre-step buffer is gone.
    The single read-modify-write chain (LR counters, optimizer updates
    whose op reads its own output) is the intended idiom and stays
    quiet: only reads strictly before the writing op mark the var as a
    consumed donated input."""
    out: List[Diagnostic] = []
    for n, defs in du.defs.items():
        v = block._find_var_recursive(n)
        if v is None or not v.persistable:
            continue
        w = defs[0]
        uses = du.uses.get(n, [])
        read_before = any(u < w for u in uses)
        read_after = [u for u in uses if u > w]
        if read_before and read_after:
            j = read_after[0]
            out.append(Diagnostic(
                diag.WARNING, diag.DONATION_ALIAS,
                f"donated state is read before its in-place write at "
                f"op#{w} ({block.ops[w].type}) and again after, by op#"
                f"{j} ({block.ops[j].type}) — the late read observes the "
                "updated value and the pre-step buffer is donated; "
                "snapshot the value before the update if both reads "
                "must agree",
                block_idx=block.idx, op_idx=j,
                op_type=block.ops[j].type, var=n))
    return out
