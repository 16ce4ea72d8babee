"""Static analysis over the Program IR (counterpart of
paddle_tpu/analysis).

Ported: the def-use utilities the inference passes share
(``dataflow``), the ``Diagnostic`` record and the restore-lint that
``ckpt.restore`` runs (``check_restore_state``). The program verifier
(``check_program``: graph validation, shape/dtype inference), liveness,
the recompile lint and the communication lints are not (ROADMAP
Queue A 8).
"""

from __future__ import annotations

from . import dataflow  # noqa: F401  (shared def-use utilities)
from .diagnostics import ERROR, WARNING, Diagnostic, render
from .restore_lint import (CKPT_EXTRA_VAR, CKPT_MISSING_VAR,
                           check_restore_state)

__all__ = ["CKPT_EXTRA_VAR", "CKPT_MISSING_VAR", "Diagnostic", "ERROR",
           "WARNING", "check_restore_state", "dataflow", "render"]
