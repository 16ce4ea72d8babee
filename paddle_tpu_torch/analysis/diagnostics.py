"""Structured diagnostics (counterpart of
paddle_tpu/analysis/diagnostics.py).

Only the record, its severities and the codes the restore-lint emits
are ported; the static program verifier that emits the other codes is
not (ROADMAP Queue A 8).
"""

from __future__ import annotations

from typing import List, Optional

ERROR = "error"
WARNING = "warning"

SHAPE_MISMATCH = "shape-mismatch"
DTYPE_MISMATCH = "dtype-mismatch"


class Diagnostic:
    """One finding, pinned to (block, op, var) context."""

    def __init__(self, severity: str, code: str, message: str,
                 block_idx: int = 0, op_idx: Optional[int] = None,
                 op_type: Optional[str] = None,
                 var: Optional[str] = None):
        self.severity = severity
        self.code = code
        self.message = message
        self.block_idx = block_idx
        self.op_idx = op_idx
        self.op_type = op_type
        self.var = var

    @property
    def is_error(self) -> bool:
        return self.severity == ERROR

    def __str__(self):
        where = f"block {self.block_idx}"
        if self.op_idx is not None:
            where += f" op#{self.op_idx}"
        if self.op_type is not None:
            where += f" ({self.op_type})"
        var = f" var {self.var!r}:" if self.var else ":"
        return f"[{self.severity}] {self.code} @ {where}{var} {self.message}"

    def __repr__(self):
        return f"Diagnostic({self})"


def render(diagnostics: List[Diagnostic]) -> str:
    """Human-readable multi-line rendering, errors first."""
    ordered = sorted(diagnostics,
                     key=lambda d: (d.severity != ERROR,
                                    d.block_idx,
                                    -1 if d.op_idx is None else d.op_idx))
    n_err = sum(d.is_error for d in ordered)
    n_warn = len(ordered) - n_err
    head = (f"check_program: {n_err} error(s), {n_warn} warning(s)"
            if ordered else "check_program: clean (no diagnostics)")
    return "\n".join([head] + ["  " + str(d) for d in ordered])
