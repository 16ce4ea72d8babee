"""Structured diagnostics for the static program verifier (counterpart
of paddle_tpu/analysis/diagnostics.py, the same record and codes).

Reference: the PADDLE_ENFORCE machinery surfaces op-level context as
formatted strings at the failure site (platform/enforce.h:241); here the
analyzer returns *records* so callers (tests, the Executor gate,
``Program.validate``) can filter by severity/code and render
consistently.
"""

from __future__ import annotations

from typing import List, Optional

ERROR = "error"
WARNING = "warning"

# Diagnostic codes (one kebab-case slug per defect class).
UNDEFINED_VAR = "undefined-var"
USE_BEFORE_DEF = "use-before-def"
WRITE_AFTER_WRITE = "write-after-write"
DANGLING_FETCH = "dangling-fetch"
SUBBLOCK_UNRESOLVED = "subblock-unresolved"
DONATION_ALIAS = "donation-alias"
SHAPE_MISMATCH = "shape-mismatch"
DTYPE_MISMATCH = "dtype-mismatch"
MAYBE_UNINITIALIZED = "maybe-uninitialized"
RECOMPILE_HAZARD = "recompile-hazard"
# Communication lints (opt-in via check_program(with_comm=True)); the
# predicted-collective model behind them lives in analysis/spmd.py.
COMM_LAYOUT_TRANSITION = "comm-layout-transition"
COMM_RESHARDING_CHURN = "comm-resharding-churn"
COMM_INDIVISIBLE_REPLICATION = "comm-indivisible-replication"
COMM_SHARDED_PERSISTABLE_WRITE = "comm-sharded-persistable-write"


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
