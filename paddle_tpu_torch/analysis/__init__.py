"""Static program verifier over the Program IR (counterpart of
paddle_tpu/analysis, the same names, signatures and diagnostic codes).

Reference: Fluid validates programs at op-registration time in C++
(InferShape/InferVarType sweeps over the ProgramDesc,
framework/shape_inference.h) and runs liveness analysis in
memory_optimization_transpiler.py. This package is that capability for
the Program IR: catch malformed programs before a run, and statically
predict device-memory footprint and recapture hazards.

Pillars (one module each):

  * op_registry — declarative per-op shape/dtype signatures on an
    unknown-dim lattice (+ ``register_signature`` for new ops);
  * infer      — abstract interpreter propagating types through every
    block, with the op's torch fn on meta tensors as the fallback
    shape function;
  * validate   — structural graph checks emitting ``Diagnostic`` records
    (undefined vars, ordering, persistable WAW, dangling fetches,
    sub-block resolution, donation aliasing);
  * liveness   — per-op live sets and the peak-memory report behind
    ``fluid.memory_optimize(print_log=True)`` and the ``remat_policy``
    pass;
  * recompile  — lint for feed shapes that defeat the captured graphs,
    cross-checked against serving bucket configs;
  * restore_lint — the checkpoint restore-lint ``ckpt.restore`` runs.

Entry points: :func:`check_program` (everything at once),
``Program.validate()``, and the ``check_program`` flag read by the
Executor. The SPMD communication analysis (``with_comm``,
``analyze_comm``) is not ported (ROADMAP Queue A 9). The CLI is
``python -m paddle_tpu_torch.tools.check_program``.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

from ..core.enforce import not_ported
from ..core.program import Program
from . import dataflow  # noqa: F401  (shared def-use utilities)
from .diagnostics import ERROR, WARNING, Diagnostic, render
from .infer import InferResult, infer_program_types
from .liveness import MemoryReport, TensorLife, analyze_liveness
from .op_registry import (SignatureError, TensorType, UNKNOWN,
                          register_signature, registered_ops)
from .recompile import (check_dataloader_shapes, check_decode_feeds,
                        check_serving_buckets, find_recompile_hazards)
from .restore_lint import (CKPT_EXTRA_VAR, CKPT_MISSING_VAR,
                           check_restore_state)
from .validate import validate_graph

__all__ = [
    "AnalysisReport", "CKPT_EXTRA_VAR", "CKPT_MISSING_VAR", "Diagnostic",
    "ERROR", "InferResult", "MemoryReport", "SignatureError", "TensorLife",
    "TensorType", "UNKNOWN", "WARNING", "analyze_liveness",
    "check_dataloader_shapes", "check_decode_feeds", "check_program",
    "check_restore_state", "check_serving_buckets", "dataflow",
    "find_recompile_hazards", "infer_program_types", "register_signature",
    "registered_ops", "render", "validate_graph",
]


class AnalysisReport:
    """Everything one verification sweep found, filterable by severity
    and diagnostic code; ``str()`` renders the human-readable listing."""

    def __init__(self, diagnostics: List[Diagnostic],
                 inferred: Optional[InferResult] = None,
                 memory: Optional[MemoryReport] = None):
        self.diagnostics = list(diagnostics)
        self.inferred = inferred
        self.memory = memory

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    @property
    def ok(self) -> bool:
        return not self.errors

    def by_code(self, code: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    def __str__(self):
        text = render(self.diagnostics)
        if self.memory is not None:
            text += "\n" + self.memory.render()
        return text

    def __repr__(self):
        return (f"AnalysisReport(errors={len(self.errors)}, "
                f"warnings={len(self.warnings)})")


def check_program(program: Optional[Program] = None,
                  feed: Iterable[str] = (),
                  fetch_list: Iterable = (),
                  buckets: Optional[Sequence[int]] = None,
                  strict_batch: bool = False,
                  with_memory: bool = False,
                  with_comm: bool = False,
                  assume_batch: int = 1) -> AnalysisReport:
    """Run the full static verifier over ``program`` (default: the
    default main program): graph validation, shape/dtype inference, and
    the recompile-hazard lint; optionally the liveness/peak-memory
    report.

    ``feed``/``fetch_list`` mirror Executor.run's arguments and sharpen
    the checks (fed names count as defined; fetch targets are checked
    for danglingness). ``buckets`` is a serving bucket config for the
    recompile cross-check; ``strict_batch=True`` (serving-oriented
    callers) additionally flags a dynamic batch axis those buckets do
    not cover. ``with_comm=True`` raises NotImplementedError (the SPMD
    communication analysis, ROADMAP Queue A 9). Otherwise raises
    nothing: all findings come back as :class:`Diagnostic` records on
    the report.
    """
    from ..core.program import default_main_program

    if with_comm:
        raise not_ported("check_program(with_comm=True): the SPMD "
                         "communication analysis", "Queue A 9")
    program = program or default_main_program()
    diags: List[Diagnostic] = []
    diags.extend(validate_graph(program, feed=feed,
                                fetch_list=fetch_list))
    inferred = infer_program_types(program)
    diags.extend(inferred.diagnostics)
    diags.extend(find_recompile_hazards(
        program, feed_names=tuple(feed or ()) or None, buckets=buckets,
        strict_batch=strict_batch))
    memory = None
    if with_memory:
        memory = analyze_liveness(program, fetch_list=fetch_list,
                                  feed=feed, assume_batch=assume_batch)
    return AnalysisReport(diags, inferred=inferred, memory=memory)
