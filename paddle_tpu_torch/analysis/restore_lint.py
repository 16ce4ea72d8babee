"""Restore-lint: checkpoint manifest vs program symbol table (counterpart
of paddle_tpu/analysis/restore_lint.py).

The checkpoint's per-tensor global (shape, dtype) records are checked
against the program's declared persistables before any payload is read:

  * ``shape-mismatch`` / ``dtype-mismatch`` (ERROR) — the checkpoint
    value cannot be this program's variable;
  * ``ckpt-missing-var`` (WARNING) — a persistable the checkpoint does
    not carry keeps its startup initialization;
  * ``ckpt-extra-var`` (WARNING) — a checkpoint entry no program
    variable claims.

Fused flat state is resolved through the program's view table: a flat
buffer is covered when the checkpoint carries it or every view over it,
and a view when the checkpoint carries its flat buffer. A two-byte raw
member (``void16``: bfloat16 bits written without the dtype's name, as
the JAX package's dense checkpoints hold them) fits a variable the
program declares bfloat16.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..core import dtype_utils
from ..core.program import Program
from .diagnostics import (DTYPE_MISMATCH, ERROR, SHAPE_MISMATCH, WARNING,
                          Diagnostic)

CKPT_MISSING_VAR = "ckpt-missing-var"
CKPT_EXTRA_VAR = "ckpt-extra-var"


def _shapes_compatible(declared, saved) -> bool:
    if declared is None:
        return True
    declared = tuple(declared)
    saved = tuple(saved)
    if len(declared) != len(saved):
        return False
    for d, s in zip(declared, saved):
        if int(d) >= 0 and int(d) != int(s):  # -1 = dynamic: anything fits
            return False
    return True


def _dtypes_compatible(declared, saved: str) -> bool:
    want = dtype_utils.name(declared)
    return saved == want or (saved == "void16" and want == "bfloat16")


def check_restore_state(program: Program,
                        entries: Dict[str, Tuple[tuple, str]]
                        ) -> List[Diagnostic]:
    """Lint ``entries`` ({name: (global shape tuple, dtype name)}, what
    ``ckpt.manifest_entries`` returns) against ``program``'s persistable
    symbol table. Returns Diagnostic records; raises nothing."""
    gb = program.global_block()
    views = getattr(program, "_flat_state_views", None) or {}
    flats: Dict[str, list] = {}
    for vname, spec in views.items():
        flats.setdefault(spec[0], []).append(vname)
    diags: List[Diagnostic] = []
    persistables = {n: v for n, v in gb.vars.items() if v.persistable}
    for name, var in sorted(persistables.items()):
        if name not in entries:
            covered = (
                (name in views and views[name][0] in entries)
                or (name in flats
                    and all(v in entries for v in flats[name])))
            if not covered:
                diags.append(Diagnostic(
                    WARNING, CKPT_MISSING_VAR,
                    "persistable not in the checkpoint — keeps its "
                    "startup initialization", var=name))
            continue
        shape, dtype = entries[name]
        if not _shapes_compatible(var.shape, shape):
            diags.append(Diagnostic(
                ERROR, SHAPE_MISMATCH,
                "checkpoint shape %s != declared %s"
                % (tuple(shape), tuple(var.shape)), var=name))
        elif var.dtype is not None and \
                not _dtypes_compatible(var.dtype, dtype):
            diags.append(Diagnostic(
                ERROR, DTYPE_MISMATCH,
                "checkpoint dtype %s != declared %s"
                % (dtype, dtype_utils.name(var.dtype)), var=name))
    declared = set(persistables) | set(views)
    for name in sorted(set(entries) - declared):
        diags.append(Diagnostic(
            WARNING, CKPT_EXTRA_VAR,
            "checkpoint entry matches no program persistable — ignored "
            "by this program", var=name))
    return diags
