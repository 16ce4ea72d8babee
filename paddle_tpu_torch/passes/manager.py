"""The pass manager in its legacy mode (counterpart of
paddle_tpu/core/passes.py's ``PassManager``/``apply_passes``/
``inference_pass_pipeline``, which run paddle_tpu/passes/manager.py
with ``check=False, stamp=False``).

Legacy mode applies the passes in order and nothing else. The checked
and stamped manager of the JAX package — re-inference after every pass,
the zero-new-diagnostic invariant, the declared-write check and the
composed ``_passes_stamp`` — needs the program verifier
(``analysis.check_program``), which is not ported: asking for it raises
(ROADMAP Queue A 8).
"""

from __future__ import annotations

from typing import List, Sequence, Union

from ..core.enforce import not_ported
from ..core.program import Program
from .base import Pass, PassError, get_pass
from .fusion import (AttentionFusePass, DeadCodeEliminatePass,
                     FcActFusePass, TransposeEliminatePass)


class PassManager:
    """Ordered pass pipeline over one Program. ``passes`` — registered
    names and/or :class:`Pass` instances. Only ``check=False,
    stamp=False`` (the legacy mode) is ported; the defaults of the JAX
    package's manager (both on) raise NotImplementedError."""

    def __init__(self, passes: Sequence[Union[str, Pass]],
                 check: bool = True, stamp: bool = True,
                 lint_comm: bool = False):
        if check or stamp or lint_comm:
            raise not_ported(
                "the checked and stamped PassManager (check=%s, stamp=%s, "
                "lint_comm=%s; pass check=False, stamp=False for the "
                "legacy manager)" % (check, stamp, lint_comm), "Queue A 8")
        self.passes: List[Pass] = [
            p if isinstance(p, Pass) else get_pass(p) for p in passes]
        self.check = self.stamp = self.lint_comm = False

    def apply(self, program: Program, scope=None) -> Program:
        for p in self.passes:
            out = p.apply(program, scope=scope)
            if out is None:
                raise PassError(p.name, PassError.BAD_RESULT,
                                "apply() returned None instead of a "
                                "Program")
            program = out
        return program

    def __repr__(self):
        return "PassManager(%s)" % ", ".join(p.name for p in self.passes)


def apply_passes(passes: Sequence[Union[str, Pass]], program: Program,
                 scope=None, check: bool = True, stamp: bool = True,
                 lint_comm: bool = False) -> Program:
    """One-call pipeline: ``apply_passes(["dce"], program, check=False,
    stamp=False)``."""
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
